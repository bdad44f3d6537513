// K2 — decode attention over one bf16 KV-cache layer for Hopper (sm_90a).
//
// Replaces the Pallas kernel fun_asr_gguf_tpu/ops/flash_decode.py
// flash_decode_attention (bf16-cache branch) and matches the XLA reference
// fun_asr_gguf_tpu/models/qwen3.py _attend_cache: f32 scores, one EXACT
// softmax over the whole cache row (masked slots carry a -1e30 bias),
// probabilities normalised in f32 with the max(l, 1e-30) clamp and then
// rounded to bf16 for the mix, f32 accumulation, bf16 output.
//
// One block per (kv head, batch row) serves the `group` query heads that
// share the kv head (GQA: query head h reads kv head h / group) for all T
// query rows — R = T * group rows. Phase 1: the R query rows sit in shared
// memory; each lane takes its own cache slot and dots the whole K row with
// every query row (broadcast reads, no shuffle reduction, which made the
// earlier lanes-split-head_dim mapping cost 5 shuffles per (slot, row) and
// grew with R); scores land in shared memory. Phase 2: one warp per row finds max/sum and writes the bf16-rounded
// probabilities back. Phase 3: warps take slots in turn again, lanes own 4
// head_dim columns, so every V row is read once, coalesced; the per-warp
// partial sums meet in shared memory.
//
// Bound by cache bytes (2 x S x kh x hd x 2 B per layer; 4 MB at S = 1024 for
// Qwen3-0.6B) plus a per-layer launch; split-KV over more blocks is a later
// PR's work (B x kh = 8 blocks per call at batch 1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHd = 128;          // head_dim (lanes x 4)
constexpr int kMaxR = 18;         // T * group rows per block: verify at
                                  // spec_k = 8 is 9 rows x GQA group 2
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int MR>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ kc,
                    const __nv_bfloat16* __restrict__ vc,
                    const float* __restrict__ bias,
                    __nv_bfloat16* __restrict__ out,
                    int T, int qh, int kh, int S) {
  extern __shared__ float smem[];
  const int group = qh / kh;
  const int R = T * group;
  float* sc = smem;                          // [R][S] scores -> probs
  // [warps][R][hd], 16-byte aligned for the float4 reads of phase 1
  float* red = smem + ((static_cast<size_t>(R) * S + 3) & ~size_t{3});

  const int hk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // query rows r = t*group + g -> head hk*group + g, staged in f32 in the
  // region phase 3 reduces into (unused until then)
  float* qs = red;                                   // [R][hd]
  for (int i = tid; i < R * kHd; i += kThreads) {
    const int r = i / kHd, t = r / group, h = hk * group + r % group;
    qs[i] = __bfloat162float(
        q[((static_cast<size_t>(b) * T + t) * qh + h) * kHd + i % kHd]);
  }
  __syncthreads();

  // phase 1: scores; each lane takes one cache slot (32 per warp step) and
  // dots its whole K row with all R query rows, read from shared memory as
  // broadcasts: no shuffle reduction per (slot, row)
  const size_t row_stride = static_cast<size_t>(kh) * kHd;    // per slot
  const __nv_bfloat16* kb = kc + static_cast<size_t>(b) * S * row_stride +
                            static_cast<size_t>(hk) * kHd;
  for (int s = warp * 32 + lane; s < S; s += kWarps * 32) {
    const __nv_bfloat16* kr = kb + static_cast<size_t>(s) * row_stride;
    float acc[MR];
#pragma unroll
    for (int r = 0; r < MR; ++r) acc[r] = 0.f;
#pragma unroll 2
    for (int c = 0; c < kHd; c += 8) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(kr + c));
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
      float kv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) kv[i] = __bfloat162float(e[i]);
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        if (r < R) {
          const float4 q0 = *reinterpret_cast<const float4*>(qs + r * kHd + c);
          const float4 q1 =
              *reinterpret_cast<const float4*>(qs + r * kHd + c + 4);
          float a = acc[r];
          a = fmaf(q0.x, kv[0], a); a = fmaf(q0.y, kv[1], a);
          a = fmaf(q0.z, kv[2], a); a = fmaf(q0.w, kv[3], a);
          a = fmaf(q1.x, kv[4], a); a = fmaf(q1.y, kv[5], a);
          a = fmaf(q1.z, kv[6], a); a = fmaf(q1.w, kv[7], a);
          acc[r] = a;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < MR; ++r)
      if (r < R)
        sc[static_cast<size_t>(r) * S + s] =
            acc[r] + bias[(static_cast<size_t>(b) * T + r / group) * S + s];
  }
  __syncthreads();

  // phase 2: exact softmax per row, probabilities rounded to bf16
  for (int r = warp; r < R; r += kWarps) {
    float* row = sc + static_cast<size_t>(r) * S;
    float mx = -INFINITY;
    for (int s = lane; s < S; s += 32) mx = fmaxf(mx, row[s]);
    mx = warp_max(mx);
    float l = 0.f;
    for (int s = lane; s < S; s += 32) {
      const float p = __expf(row[s] - mx);
      row[s] = p;
      l += p;
    }
    l = warp_sum(l);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    for (int s = lane; s < S; s += 32)
      row[s] = __bfloat162float(__float2bfloat16(row[s] * inv));
  }
  __syncthreads();

  // phase 3: mix; warp w takes slots w, w + 8, ..., its lanes 4 columns
  // each (one coalesced 256-byte V row per step), then the 8 warps'
  // partial sums are added in shared memory
  const __nv_bfloat16* vb = vc + static_cast<size_t>(b) * S * row_stride +
                            static_cast<size_t>(hk) * kHd + lane * 4;
  float acc[MR][4];
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;
#pragma unroll 4
  for (int s = warp; s < S; s += kWarps) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(
        vb + static_cast<size_t>(s) * row_stride));
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      if (r < R) {
        const float p = sc[static_cast<size_t>(r) * S + s];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[r][i] = fmaf(p, __bfloat162float(e[i]), acc[r][i]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < MR; ++r)
    if (r < R)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        red[(static_cast<size_t>(warp) * R + r) * kHd + lane * 4 + i] =
            acc[r][i];
  __syncthreads();
  for (int idx = tid; idx < R * kHd; idx += kThreads) {
    const int r = idx / kHd, c = idx % kHd;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      v += red[(static_cast<size_t>(w) * R + r) * kHd + c];
    const int t = r / group, h = hk * group + r % group;
    // out [B, qh, T, hd]
    out[((static_cast<size_t>(b) * qh + h) * T + t) * kHd + c] =
        __float2bfloat16(v);
  }
}

}  // namespace

// q: bf16 [B, T, qh, hd] (pre-scaled); k, v: bf16 [B, S, kh, hd];
// bias: f32 [B, T, S]; out: bf16 [B, qh, T, hd]. hd == 128,
// T * (qh / kh) <= 18 (checked by the wrapper).
extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* bias, void* out, int B, int T,
                                 int qh, int kh, int S, int hd, void* stream) {
  if (hd != kHd || qh % kh != 0 || T * (qh / kh) > kMaxR)
    return static_cast<int>(cudaErrorInvalidValue);
  const int R = T * (qh / kh);
  const size_t smem =
      (((static_cast<size_t>(R) * S + 3) & ~size_t{3}) + kWarps * R * kHd) *
      sizeof(float);
  // two instances: R <= 4 serves the decode step (one row per query head
  // of the group), R <= 18 the verify step; unused rows cost registers
  auto kernel = R <= 4 ? flash_decode_kernel<4> : flash_decode_kernel<kMaxR>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(kh, B), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), T, qh, kh, S);
  return static_cast<int>(cudaGetLastError());
}
