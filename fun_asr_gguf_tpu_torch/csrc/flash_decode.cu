// K2 — decode attention over one KV-cache layer for Hopper (sm_90a), over
// a bf16 cache (K2) or an int8 cache with per-(slot, kv head) scales (K2-i8):
// split-KV over every SM, one launch per call.
//
// Replaces the Pallas kernel fun_asr_gguf_tpu/ops/flash_decode.py
// flash_decode_attention (both branches) with the numerics of the XLA
// reference fun_asr_gguf_tpu/models/qwen3.py _attend_cache: f32 scores,
// max and sums, probabilities rounded to bf16 for the mix, f32
// accumulation, bf16 output. Where the probabilities are rounded moves, as
// in JAX's own K5 stage (quant_matmul.py :1870-1880): each chunk rounds its
// unnormalised exp(s - m_chunk), and the combine divides by the merged sum.
// With the int8 cache the scales commute out of the head_dim contraction
// (_attend_cache's QuantKV branch): K's scale multiplies the slot's score
// before the bias, V's multiplies its probability before the bf16 rounding.
//
// Design (split_kv.cuh holds the device code it shares with K5): grid
// (chunk, kv head, batch row). A block serves the R = T * group query rows
// of its kv head (GQA: query head h reads kv head h / group) over one chunk
// of cache slots, staged in double-buffered tiles of 32 slots with
// cp.async, scored and mixed with mma.sync (rows padded to 16, or 32 for
// the 18-row verify round), and writes the chunk's (m, l, acc) in f32 to the
// work buffer. The last block of each (kv head, row), known from an atomic
// ticket, merges the chunks in order and writes out [B, qh, T, hd]. Shared
// memory does not grow with S, so any cache length runs.
//
// What bounds it: cache bytes. bf16, 2 x S x kh x hd x 2 B per layer (4.19
// MB at S = 1024 for Qwen3-0.6B, 1.25 us at 3.35 TB/s); int8, 2 x S x kh x
// (hd + 2) B (2.13 MB). The launch sizes the chunk so that batch 1
// gives about two blocks per SM; masked tiles are not read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

#include "split_kv.cuh"

namespace {

constexpr int kHd = skv::kHd;
constexpr int kMaxR = 18;         // T * group rows per block: verify at
                                  // spec_k = 8 is 9 rows x GQA group 2
constexpr int kWarps = 4;

struct Args {
  const __nv_bfloat16* q;        // [B, T, qh, hd], pre-scaled
  const void* k;                 // [B, S, kh, hd]
  const void* v;
  const __nv_bfloat16* ks;       // [B, S, kh, 1] (int8 cache) or null
  const __nv_bfloat16* vs;
  const float* bias;             // [B, T, S]
  __nv_bfloat16* out;            // [B, qh, T, hd]
  float* work;                   // acc [B kh nsplit][R][hd], then m, l
                                 // [B kh nsplit][R]
  int* tickets;                  // [B * kh], 0 between calls
  int T, qh, kh, S, chunk, nsplit;
};

struct OutRows {                 // out[b, h, t, d] for query row r
  __nv_bfloat16* out;
  int b, hk, group, T, qh;
  __device__ void operator()(int r, int d, float v) const {
    const int t = r / group, h = hk * group + r % group;
    out[((static_cast<size_t>(b) * qh + h) * T + t) * kHd + d] =
        __float2bfloat16(v);
  }
};

template <typename CT, int MT>
__global__ void __launch_bounds__(kWarps * 32)
flash_decode_kernel(Args a) {
  using L = skv::Smem<CT, MT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = a.qh / a.kh, R = a.T * group;

  // query rows r = t * group + g -> head hk * group + g, bf16, staged by
  // cp.async with the first tile (pad rows zero-filled)
  __nv_bfloat16* qs = skv::q_rows(smem);
  for (int i = threadIdx.x; i < L::kRows * (kHd / 8); i += kWarps * 32) {
    const int r = i / (kHd / 8), c = i % (kHd / 8);
    const bool ok = r < R;
    const __nv_bfloat16* src =
        ok ? a.q + ((static_cast<size_t>(b) * a.T + r / group) * a.qh +
                    hk * group + r % group) * kHd + c * 8
           : a.q;
    skv::cp_async16(qs + r * L::kQStride + c * 8, src, ok);
  }

  const size_t slot_stride = static_cast<size_t>(a.kh) * kHd;
  const size_t base = static_cast<size_t>(b) * a.S * slot_stride +
                      static_cast<size_t>(hk) * kHd;
  skv::StageIn in;
  in.k = static_cast<const CT*>(a.k) + base;
  in.v = static_cast<const CT*>(a.v) + base;
  in.stride = static_cast<long long>(slot_stride);
  const size_t sbase = static_cast<size_t>(b) * a.S * a.kh + hk;
  in.ks = a.ks ? a.ks + sbase : nullptr;
  in.vs = a.vs ? a.vs + sbase : nullptr;
  in.sstride = a.kh;
  in.bias = a.bias + static_cast<size_t>(b) * a.T * a.S;
  in.tstride = a.S;
  in.group = group;
  in.R = R;
  in.scale = 1.f;

  // work: acc [items][R][hd], then m [items][R], then l [items][R]
  const size_t head = static_cast<size_t>(b) * a.kh + hk;
  const size_t n_items = static_cast<size_t>(gridDim.z) * a.kh * a.nsplit;
  float* pacc = a.work + head * a.nsplit * R * kHd;
  float* pm = a.work + n_items * R * kHd + head * a.nsplit * R;
  float* pl = pm + n_items * R;
  const int s0 = split * a.chunk;
  const int s1 = min(a.S, s0 + a.chunk);
  skv::stage<CT, MT, kWarps>(in, s0, s1, smem, pm + split * R,
                             pl + split * R, pacc + split * R * kHd);
  if (skv::last_block(a.tickets + head, a.nsplit,
                      reinterpret_cast<int*>(smem + L::flag)))
    skv::combine(pm, pl, pacc, a.nsplit, R, nullptr, nullptr,
                 skv::combine_scratch<CT, MT>(smem),
                 OutRows{a.out, b, hk, group, a.T, a.qh});
}

template <typename CT, int MT>
cudaError_t run(const Args& a, int B, cudaStream_t stream) {
  using L = skv::Smem<CT, MT>;
  static std::once_flag once;
  static cudaError_t attr = cudaSuccess;
  std::call_once(once, [] {
    attr = cudaFuncSetAttribute(flash_decode_kernel<CT, MT>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(L::bytes));
  });
  if (attr != cudaSuccess) return attr;
  flash_decode_kernel<CT, MT>
      <<<dim3(a.nsplit, a.kh, B), kWarps * 32, L::bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename CT>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* bias, void* out, void* work,
           void* tickets, int B, int T, int qh, int kh, int S, int hd,
           int chunk, void* stream) {
  if (hd != kHd || kh < 1 || qh % kh != 0 || T < 1 ||
      T * (qh / kh) > kMaxR || S < 1 || B < 1 || B > 65535 || kh > 65535 ||
      chunk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (chunk == 0) {
    // about two blocks per SM; more than 16 query rows (the verify round)
    // take at least two tiles per chunk, which spreads a block's fixed
    // cost (its query rows and its partial) over double-buffered tiles
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    chunk = skv::chunk_slots(S, B * kh, 2 * sms);
    if (T * (qh / kh) > 16 && chunk < 2 * skv::kTile) chunk = 2 * skv::kTile;
  }
  if ((S + chunk - 1) / chunk > skv::kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const __nv_bfloat16*>(q), k, v,
         static_cast<const __nv_bfloat16*>(ks),
         static_cast<const __nv_bfloat16*>(vs),
         static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out),
         static_cast<float*>(work), static_cast<int*>(tickets),
         T, qh, kh, S, chunk, (S + chunk - 1) / chunk};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // two instances: R <= 16 rows (the decode step, T = 1..8 at group 2)
  // and R <= 32 (the verify step's 18 rows)
  const cudaError_t e = T * (qh / kh) <= 16 ? run<CT, 1>(a, B, st)
                                            : run<CT, 2>(a, B, st);
  return static_cast<int>(e);
}

}  // namespace

// q: bf16 [B, T, qh, hd] (pre-scaled); k, v: bf16 [B, S, kh, hd];
// bias: f32 [B, T, S]; out: bf16 [B, qh, T, hd]; work: f32 [B kh nsplit R
// (hd + 2)] with nsplit = ceil(S / chunk) <= 64 and R = T qh / kh, where
// chunk 0 lets the launch pick it (whole tiles of 32 slots, so nsplit <=
// ceil(S / 32)); tickets: int32 [B kh], zero (the kernel leaves them
// zero). hd == 128, R <= 18; q, k, v and work 16-byte aligned.
extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* bias, void* out, void* work,
                                 void* tickets, int B, int T, int qh, int kh,
                                 int S, int hd, int chunk, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, nullptr, nullptr, bias, out, work,
                               tickets, B, T, qh, kh, S, hd, chunk, stream);
}

// The int8 cache: k, v int8 [B, S, kh, hd]; k_scale, v_scale bf16
// [B, S, kh, 1]; the rest as flash_decode_bf16.
extern "C" int flash_decode_i8(const void* q, const void* k, const void* v,
                               const void* k_scale, const void* v_scale,
                               const void* bias, void* out, void* work,
                               void* tickets, int B, int T, int qh, int kh,
                               int S, int hd, int chunk, void* stream) {
  return launch<int8_t>(q, k, v, k_scale, v_scale, bias, out, work, tickets,
                        B, T, qh, kh, S, hd, chunk, stream);
}
