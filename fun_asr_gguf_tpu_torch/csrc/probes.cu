// Measurement probes for Hopper (sm_90a): the H100 counterparts of two
// Pallas probes of experiments/, each held against a plain PyTorch version
// by fun_asr_gguf_tpu_torch/probes/. On no path of the engine.
//
// P12 (experiments/q8_mega_probes.py p12 :161-238): one online-softmax
// attention stage over a chunked head-major cache, started from the
// current token — here the split-KV chunk stage and combine that K2 and
// K5 run (split_kv.cuh), launched alone with a chosen chunk, so its time
// can be read against the chunk count.
//
// P5 (experiments/q8_bw_probe.py :92-204): how fast the decode's q8_0 bytes
// stream from HBM. (a) q8_stream_sum touches every byte of the int8 values
// and f32 block scales of 28 layers (o, gate_up, down, qkv: 17.69 MB a
// layer) with 16-byte loads and a trivial sum, as sum_kern :104 does: its
// rate is the achievable stream rate. (b) q8_stream_gemv runs the m = 1
// dequant GEMV of K4 / K5 (q8_gemv.cuh: one warp per output row) over the
// same bytes, as dq_kern :144 does; (c) the same GEMV reading f16 block
// scales (what the GGUF holds), the Hopper form of P5c :186-204.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "q8_gemv.cuh"
#include "split_kv.cuh"

namespace {

// ---------------------------------------------------------------- P12

constexpr int kWarps = 4;
using P12Smem = skv::Smem<__nv_bfloat16, 1>;

struct P12Args {
  const __nv_bfloat16* q;    // [qh, hd]
  const __nv_bfloat16* kc;   // [kh, hd] the current token's k, v
  const __nv_bfloat16* vc;
  const __nv_bfloat16* k;    // [kh, S, hd] head-major cache
  const __nv_bfloat16* v;
  const float* bias;         // [S]
  float* out;                // [qh, hd]
  float* work;               // [kh, nsplit, group (hd + 2)]
  int* tickets;              // [kh]
  int qh, kh, S, chunk, nsplit;
  float scale;
};

struct OutF32 {
  float* out;
  int h0;
  __device__ void operator()(int r, int d, float v) const {
    out[(h0 + r) * skv::kHd + d] = v;
  }
};

__global__ void __launch_bounds__(kWarps * 32) split_kv_probe_kernel(P12Args a) {
  constexpr int D = skv::kHd;
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x, hk = blockIdx.y;
  const int group = a.qh / a.kh;
  __nv_bfloat16* qs = skv::q_rows(smem);
  for (int i = threadIdx.x; i < P12Smem::kRows * (D / 8); i += kWarps * 32) {
    const int r = i / (D / 8), c = i % (D / 8);
    const bool ok = r < group;
    skv::cp_async16(qs + r * P12Smem::kQStride + c * 8,
                    ok ? a.q + (hk * group + r) * D + c * 8 : a.q, ok);
  }
  skv::StageIn in;
  in.k = a.k + static_cast<size_t>(hk) * a.S * D;
  in.v = a.v + static_cast<size_t>(hk) * a.S * D;
  in.stride = D;
  in.ks = in.vs = nullptr;
  in.sstride = 0;
  in.bias = a.bias;
  in.tstride = 0;
  in.group = group;
  in.R = group;
  in.scale = a.scale;
  // work: acc [kh][nsplit][group][D], then m, then l [kh][nsplit][group]
  float* pacc = a.work + static_cast<size_t>(hk) * a.nsplit * group * D;
  float* pm = a.work + static_cast<size_t>(a.kh) * a.nsplit * group * D +
              hk * a.nsplit * group;
  float* pl = pm + a.kh * a.nsplit * group;
  const int s0 = split * a.chunk, s1 = min(a.S, s0 + a.chunk);
  skv::stage<__nv_bfloat16, 1, kWarps>(in, s0, s1, smem, pm + split * group,
                                       pl + split * group,
                                       pacc + split * group * D);
  if (!skv::last_block(a.tickets + hk, a.nsplit,
                       reinterpret_cast<int*>(smem + P12Smem::flag)))
    return;
  // the current token's term: s = q . k_cur * scale, v_cur, in f32
  float* cur = reinterpret_cast<float*>(smem + P12Smem::bytes);   // [D + 16]
  for (int d = threadIdx.x; d < D; d += kWarps * 32)
    cur[d] = __bfloat162float(a.vc[hk * D + d]);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < group) {
    float s = 0.f;
    for (int d = lane; d < D; d += 32)
      s += __bfloat162float(a.q[(hk * group + warp) * D + d]) *
           __bfloat162float(a.kc[hk * D + d]);
    s = skv::warp_sum(s);
    if (lane == 0) cur[D + warp] = s * a.scale;
  }
  __syncthreads();
  skv::combine(pm, pl, pacc, a.nsplit, group, cur + D, cur,
               skv::combine_scratch<__nv_bfloat16, 1>(smem),
               OutF32{a.out, hk * group});
}

// ---------------------------------------------------------------- P5

constexpr int kStreamThreads = 256;

// (a) every byte once: int8 values summed as int, scales as float
__global__ void __launch_bounds__(kStreamThreads)
stream_sum_kernel(const int8_t* q0, const int8_t* q1, const int8_t* q2,
                  const int8_t* q3, const float* d0, const float* d1,
                  const float* d2, const float* d3, long long* isum,
                  float* fsum, int n0, int n1, int n2, int n3) {
  const int8_t* qs[4] = {q0, q1, q2, q3};
  const float* ds[4] = {d0, d1, d2, d3};
  const int ns[4] = {n0, n1, n2, n3};
  const size_t tid = static_cast<size_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  const size_t nthreads = static_cast<size_t>(gridDim.x) * blockDim.x;
  long long si = 0;
  float sf = 0.f;
  for (int m = 0; m < 4; ++m) {
    const int4* qv = reinterpret_cast<const int4*>(qs[m]);
    for (size_t i = tid; i < static_cast<size_t>(ns[m]) / 16; i += nthreads) {
      const int4 v = __ldcs(qv + i);
      const int w[4] = {v.x, v.y, v.z, v.w};
      int acc = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc = __dp4a(w[j], 0x01010101, acc);
      si += acc;
    }
    const float4* dv = reinterpret_cast<const float4*>(ds[m]);
    for (size_t i = tid; i < static_cast<size_t>(ns[m]) / 32 / 4;
         i += nthreads) {
      const float4 v = __ldcs(dv + i);
      sf += (v.x + v.y) + (v.z + v.w);
    }
  }
  __shared__ long long ri[kStreamThreads / 32];
  __shared__ float rf[kStreamThreads / 32];
  for (int o = 16; o > 0; o >>= 1) {
    si += __shfl_xor_sync(0xffffffffu, si, o);
    sf += __shfl_xor_sync(0xffffffffu, sf, o);
  }
  if ((threadIdx.x & 31) == 0) {
    ri[threadIdx.x >> 5] = si;
    rf[threadIdx.x >> 5] = sf;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long ti = 0;
    float tf = 0.f;
    for (int w = 0; w < kStreamThreads / 32; ++w) {
      ti += ri[w];
      tf += rf[w];
    }
    isum[blockIdx.x] = ti;
    fsum[blockIdx.x] = tf;
  }
}

struct GemvArgs {
  const int8_t* q[4];
  const void* d[4];
  const __nv_bfloat16* x;    // [max k]
  float* y;                  // [L, sum n]
  int n[4], k[4], L;
};

// (b), (c): every layer's four m = 1 GEMVs in one launch, through K4 /
// K5's q8_gemv.cuh gemv_rows (one warp per output row), scales of type ST
template <typename ST>
__global__ void __launch_bounds__(q8::kThreads) stream_gemv_kernel(GemvArgs a) {
  const int lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * q8::kWarps + (threadIdx.x >> 5);
  const int nwarps = gridDim.x * q8::kWarps;
  const int ntot = a.n[0] + a.n[1] + a.n[2] + a.n[3];
  for (int l = 0; l < a.L; ++l) {
    int off = 0;
    for (int m = 0; m < 4; ++m) {
      const size_t nk = static_cast<size_t>(a.n[m]) * a.k[m];
      q8::gemv_rows<1, q8::Src::kReadOnly>(
          a.q[m] + l * nk, static_cast<const ST*>(a.d[m]) + l * (nk >> 5),
          a.x, 1, a.k[m], a.n[m], nullptr,
          a.y + static_cast<size_t>(l) * ntot + off, a.n[m], gwarp, nwarps,
          lane);
      off += a.n[m];
    }
  }
}

int sms(int* n) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(e);
}

}  // namespace

// P12: q bf16 [qh, 128]; kc, vc bf16 [kh, 128]; k, v bf16 [kh, S, 128];
// bias f32 [S]; out f32 [qh, 128]; work f32 [kh ceil(S / chunk) (qh / kh)
// 130]; tickets int32 [kh], zero. qh / kh <= 16, ceil(S / chunk) <= 64.
extern "C" int split_kv_probe(const void* q, const void* kc, const void* vc,
                              const void* k, const void* v, const void* bias,
                              void* out, void* work, void* tickets, int qh,
                              int kh, int S, int chunk, float scale,
                              void* stream) {
  if (kh < 1 || qh % kh || qh / kh > 16 || S < 1 || chunk < 1 ||
      (S + chunk - 1) / chunk > skv::kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = P12Smem::bytes + (skv::kHd + 16) * sizeof(float);
  static std::once_flag once;
  static cudaError_t attr = cudaSuccess;
  std::call_once(once, [smem] {
    attr = cudaFuncSetAttribute(split_kv_probe_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  });
  if (attr != cudaSuccess) return static_cast<int>(attr);
  P12Args a{static_cast<const __nv_bfloat16*>(q),
            static_cast<const __nv_bfloat16*>(kc),
            static_cast<const __nv_bfloat16*>(vc),
            static_cast<const __nv_bfloat16*>(k),
            static_cast<const __nv_bfloat16*>(v),
            static_cast<const float*>(bias), static_cast<float*>(out),
            static_cast<float*>(work), static_cast<int*>(tickets),
            qh, kh, S, chunk, (S + chunk - 1) / chunk, scale};
  split_kv_probe_kernel<<<dim3(a.nsplit, kh), kWarps * 32, smem,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// P5 (a): q0..q3 int8 (n0..n3 bytes, multiples of 512), d0..d3 f32 block
// scales (n / 32 each); isum int64 [blocks], fsum f32 [blocks] per-block
// sums.
extern "C" int q8_stream_sum(const void* q0, const void* q1, const void* q2,
                             const void* q3, const void* d0, const void* d1,
                             const void* d2, const void* d3, void* isum,
                             void* fsum, int n0, int n1, int n2, int n3,
                             int blocks, void* stream) {
  if (blocks < 1 || (n0 | n1 | n2 | n3) % 512)
    return static_cast<int>(cudaErrorInvalidValue);
  stream_sum_kernel<<<blocks, kStreamThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q0), static_cast<const int8_t*>(q1),
      static_cast<const int8_t*>(q2), static_cast<const int8_t*>(q3),
      static_cast<const float*>(d0), static_cast<const float*>(d1),
      static_cast<const float*>(d2), static_cast<const float*>(d3),
      static_cast<long long*>(isum), static_cast<float*>(fsum), n0, n1, n2,
      n3);
  return static_cast<int>(cudaGetLastError());
}

// P5 (b) / (c): stacked q8_0 weights q_m int8 [L, n_m, k_m] with block
// scales d_m [L, n_m, k_m / 32], f32 (f16_scales = 0) or f16 (1); x bf16
// [max k]; y f32 [L, n0 + n1 + n2 + n3]. k_m % 512 == 0.
extern "C" int q8_stream_gemv(const void* q0, const void* q1, const void* q2,
                              const void* q3, const void* d0, const void* d1,
                              const void* d2, const void* d3, const void* x,
                              void* y, int n0, int k0, int n1, int k1, int n2,
                              int k2, int n3, int k3, int L, int f16_scales,
                              void* stream) {
  if (L < 1 || (k0 | k1 | k2 | k3) % 512)
    return static_cast<int>(cudaErrorInvalidValue);
  GemvArgs a{{static_cast<const int8_t*>(q0), static_cast<const int8_t*>(q1),
              static_cast<const int8_t*>(q2), static_cast<const int8_t*>(q3)},
             {d0, d1, d2, d3},
             static_cast<const __nv_bfloat16*>(x),
             static_cast<float*>(y),
             {n0, n1, n2, n3},
             {k0, k1, k2, k3},
             L};
  int n_sm = 0;
  const int e = sms(&n_sm);
  if (e) return e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f16_scales)
    stream_gemv_kernel<__half><<<4 * n_sm, q8::kThreads, 0, st>>>(a);
  else
    stream_gemv_kernel<float><<<4 * n_sm, q8::kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
