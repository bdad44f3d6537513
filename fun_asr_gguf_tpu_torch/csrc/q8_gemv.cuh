// The warp-per-row q8_0 GEMV of the probes (the P2 probe q8_probe.cu,
// P5(b) in probes.cu), the RMSNorm of an f32 row into shared memory and
// the loads they use. No path kernel includes it.
//
// Numerics: every q*d is formed in f32 and rounded to bf16 once (the JAX
// reference dequant); activations entering a product are bf16; sums
// accumulate in f32. Data written inside the same launch is read with
// ld.global.cg (L2), never through the read-only path.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "q8_warp.cuh"

namespace q8 {

enum class Src { kShared, kReadOnly, kL2 };

__device__ __forceinline__ float deq(int8_t q, float s) {
  // q*d in f32, rounded to bf16 once (the reference dequant), back to f32
  return __bfloat162float(__float2bfloat16(static_cast<float>(q) * s));
}

// a q8_0 block scale: f32 (the port's layout) or f16 (the GGUF's)
__device__ __forceinline__ float scale_at(const float* d, int i) {
  return __ldg(d + i);
}
__device__ __forceinline__ float scale_at(const __half* d, int i) {
  return __half2float(__ldg(d + i));
}

template <Src S>
__device__ __forceinline__ uint4 load16(const __nv_bfloat16* p) {
  const uint4* v = reinterpret_cast<const uint4*>(p);
  if constexpr (S == Src::kShared) return *v;
  else if constexpr (S == Src::kReadOnly) return __ldg(v);
  else return __ldcg(v);
}

// acc[j][r] += x[r, :k] . bf16(q_j * d_j) for NR weight rows q_j, all m
// activation rows; x rows are `k` apart. Lane partial sums (not reduced).
// ST: the type of the block scales (float or __half).
template <int MT, int NR, Src S, typename ST>
__device__ __forceinline__ void rows_dot(const int8_t* const (&q)[NR],
                                         const ST* const (&d)[NR],
                                         const __nv_bfloat16* x, int m, int k,
                                         int lane, float (&acc)[NR][MT]) {
#pragma unroll 2
  for (int kk = lane * 16; kk < k; kk += 512) {
    float w[NR][16];
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const int4 qv = __ldg(reinterpret_cast<const int4*>(q[j] + kk));
      const float s = scale_at(d[j], kk >> 5);
      const int8_t* qb = reinterpret_cast<const int8_t*>(&qv);
#pragma unroll
      for (int i = 0; i < 16; ++i) w[j][i] = deq(qb[i], s);
    }
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      if (r < m) {
        const __nv_bfloat16* xp = x + static_cast<size_t>(r) * k + kk;
        const uint4 xv[2] = {load16<S>(xp), load16<S>(xp + 8)};
        const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(xv);
#pragma unroll
        for (int j = 0; j < NR; ++j) {
          float a = 0.f;
#pragma unroll
          for (int i = 0; i < 16; ++i)
            a = fmaf(w[j][i], __bfloat162float(xb[i]), a);
          acc[j][r] += a;
        }
      }
    }
  }
}

// nh[r, :] = bf16((x[r, :] * 1/sqrt(mean(x[r, :]^2) + eps)) * w) into shared
// memory, one warp per row; x was written inside this launch (read via L2).
__device__ __forceinline__ void rms_rows_to_smem(const float* x,
                                                 const __nv_bfloat16* w,
                                                 int m, int h, float eps,
                                                 __nv_bfloat16* nh) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < m; r += kWarps) {
    const float* xr = x + static_cast<size_t>(r) * h;
    float ss = 0.f;
    for (int c = lane * 4; c < h; c += 128) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(xr + c));
      ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
    }
    const float inv = 1.f / sqrtf(warp_sum(ss) / static_cast<float>(h) + eps);
    for (int c = lane * 4; c < h; c += 128) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(xr + c));
      const uint2 wr = __ldg(reinterpret_cast<const uint2*>(w + c));
      const __nv_bfloat16* wb = reinterpret_cast<const __nv_bfloat16*>(&wr);
      __nv_bfloat16* o = nh + static_cast<size_t>(r) * h + c;
      o[0] = __float2bfloat16((v.x * inv) * __bfloat162float(wb[0]));
      o[1] = __float2bfloat16((v.y * inv) * __bfloat162float(wb[1]));
      o[2] = __float2bfloat16((v.z * inv) * __bfloat162float(wb[2]));
      o[3] = __float2bfloat16((v.w * inv) * __bfloat162float(wb[3]));
    }
  }
}

// One output row per warp of the grid: y[r*ld + j] = x[r] . bf16(w_j) (+
// add[r*ld + j] when add is not null, read via L2) for j < n, all m rows.
template <int MT, Src S, typename ST>
__device__ __forceinline__ void gemv_rows(const int8_t* wq, const ST* wd,
                                          const __nv_bfloat16* x, int m,
                                          int k, int n, const float* add,
                                          float* y, int ld, int gwarp,
                                          int nwarps, int lane) {
  for (int j = gwarp; j < n; j += nwarps) {
    const int8_t* const q[1] = {wq + static_cast<size_t>(j) * k};
    const ST* const d[1] = {wd + static_cast<size_t>(j) * (k >> 5)};
    float acc[1][MT] = {};
    rows_dot<MT, 1, S>(q, d, x, m, k, lane, acc);
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      if (r < m) {
        const float v = warp_sum(acc[0][r]);
        if (lane == 0) {
          const size_t i = static_cast<size_t>(r) * ld + j;
          y[i] = add ? v + __ldcg(add + i) : v;
        }
      }
    }
  }
}

// act[r*f + j] = bf16(silu(x . gate_j) * (x . up_j)), gate rows [0, f) and
// up rows [f, 2f) of wq; the warp that takes gate row j takes up row j + f.
template <int MT>
__device__ __forceinline__ void gate_up_rows(const int8_t* wq,
                                             const float* wd,
                                             const __nv_bfloat16* x, int m,
                                             int k, int f,
                                             __nv_bfloat16* act, int gwarp,
                                             int nwarps, int lane) {
  for (int j = gwarp; j < f; j += nwarps) {
    const int8_t* const q[2] = {wq + static_cast<size_t>(j) * k,
                                wq + static_cast<size_t>(j + f) * k};
    const float* const d[2] = {wd + static_cast<size_t>(j) * (k >> 5),
                               wd + static_cast<size_t>(j + f) * (k >> 5)};
    float acc[2][MT] = {};
    rows_dot<MT, 2, Src::kShared>(q, d, x, m, k, lane, acc);
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      if (r < m) {
        const float g = warp_sum(acc[0][r]);
        const float u = warp_sum(acc[1][r]);
        if (lane == 0)
          act[static_cast<size_t>(r) * f + j] =
              __float2bfloat16(g / (1.f + expf(-g)) * u);
      }
    }
  }
}

}  // namespace q8
