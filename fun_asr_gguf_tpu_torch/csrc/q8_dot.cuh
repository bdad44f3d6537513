// Device helpers of the int8-dot q8_0 product (K6 q8dot_matmul.cu): the
// q8_0 quantization of f32 activation rows into shared memory, the
// per-block s8 x s8 dot with both block scales, and the cached grid size of
// a kernel. K7 (q8_layer_fused.cu) computes the same contract on the
// streaming engine.
//
// Numerics: llama.cpp's q8_0 x q8_0 vec_dot contract, as JAX's
// quantize_act_q8 (fun_asr_gguf_tpu/ops/quant_matmul.py:1340) and _q8dot_ref
// (:1399) state it:
//   d = amax / 127 per 32-block (IEEE division), inv = 0 if d == 0 else 1/d,
//   q = sign(x * inv) * floor(|x * inv| + 0.5)   (ties away from zero);
//   partial = sum_t q_w[t] * q_x[t], exact in int32 (dp4a);
//   y += float(partial) * d_w * d_x, summed in f32.
// x * inv is taken with __fmul_rn so that nvcc cannot contract it into an
// FMA; nothing here may be built with -use_fast_math. Data written inside
// the same launch is read with ld.global.cg (L2), never through the
// read-only path.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

#include "q8_gemv.cuh"

namespace q8dot {

using q8::kThreads;
using q8::kWarps;
using q8::warp_max;
using q8::warp_sum;

// The q8_0 quantization of one 32-block held one value per lane: the
// lane's int8 goes to q[lane], the block scale to *s (lane 0).
__device__ __forceinline__ void quant_block(float v, int lane, int8_t* q,
                                            float* s) {
  const float amax = warp_max(fabsf(v));
  const float d = amax / 127.0f;
  const float inv = d == 0.f ? 0.f : 1.0f / d;
  const float t = __fmul_rn(v, inv);
  const float r = floorf(fabsf(t) + 0.5f);
  q[lane] = static_cast<int8_t>(static_cast<int>(copysignf(r, t)));
  if (lane == 0) *s = d;
}

// xq[r * k + c] and xs[r * k/32 + c/32]: the q8_0 form of value(r, c) for
// r < m, c < k, one warp per 32-block. The caller syncs the block after.
template <class F>
__device__ __forceinline__ void quant_rows_to_smem(F value, int m, int k,
                                                   int8_t* xq, float* xs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nb = k >> 5;
  for (int i = warp; i < m * nb; i += kWarps) {
    const int r = i / nb, c = (i - r * nb) * 32;
    quant_block(value(r, c + lane), lane, xq + r * k + c, xs + i);
  }
}

__device__ __forceinline__ int dot32(const int4 (&w)[2], const int4 (&x)[2]) {
  int z = __dp4a(w[0].x, x[0].x, 0);
  z = __dp4a(w[0].y, x[0].y, z);
  z = __dp4a(w[0].z, x[0].z, z);
  z = __dp4a(w[0].w, x[0].w, z);
  z = __dp4a(w[1].x, x[1].x, z);
  z = __dp4a(w[1].y, x[1].y, z);
  z = __dp4a(w[1].z, x[1].z, z);
  return __dp4a(w[1].w, x[1].w, z);
}

// acc[j][r] += sum over this lane's 32-blocks b (lane, lane + 32, ...) of
// float(q_j[b] . xq[r, b]) * d_j[b] * xs[r, b], for NR weight rows q_j and
// all m activation rows of the q8_0 rows xq / xs in shared memory (rows k
// apart). Lane partial sums, not reduced. A lane reads its block's 32
// weight bytes as two 16-byte loads; the warp reads 1 KB of a row at once.
template <int MT, int NR>
__device__ __forceinline__ void dot_rows(const int8_t* const (&q)[NR],
                                         const float* const (&d)[NR],
                                         const int8_t* xq, const float* xs,
                                         int m, int k, int lane,
                                         float (&acc)[NR][MT]) {
  const int nb = k >> 5;
  for (int b = lane; b < nb; b += 32) {
    int4 w[NR][2];
    float s[NR];
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const int4* p = reinterpret_cast<const int4*>(q[j] + b * 32);
      w[j][0] = __ldg(p);
      w[j][1] = __ldg(p + 1);
      s[j] = __ldg(d[j] + b);
    }
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      if (r < m) {
        const int4* xp = reinterpret_cast<const int4*>(xq + r * k + b * 32);
        const int4 x[2] = {xp[0], xp[1]};
        const float xsr = xs[r * nb + b];
#pragma unroll
        for (int j = 0; j < NR; ++j)
          acc[j][r] = fmaf(static_cast<float>(dot32(w[j], x)) * s[j], xsr,
                           acc[j][r]);
      }
    }
  }
}

// Grid size of `kernel` at `smem` dynamic shared-memory bytes per block:
// the SM count times the blocks per SM the occupancy query allows, at most
// `cap`. Cached per (kernel, device, key), so a decode step's launches
// make no query; the shared-memory opt-in above 48 KB only grows per
// (kernel, device), so a larger configuration cached earlier keeps its
// opt-in.
template <class K>
cudaError_t grid_blocks(K kernel, int dev, int key, size_t smem, int cap,
                        int* blocks) {
  using Id = std::pair<const void*, int>;             // (kernel, dev)
  static std::mutex mu;
  static std::map<std::pair<Id, int>, int> cache;     // (id, key) -> blocks
  static std::map<Id, size_t> smem_attr;              // id -> opt-in set
  std::lock_guard<std::mutex> lock(mu);
  const Id id{reinterpret_cast<const void*>(kernel), dev};
  const auto hit = cache.find({id, key});
  if (hit != cache.end()) {
    *blocks = hit->second;
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  cudaError_t e =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && smem > 48 * 1024 && smem > smem_attr[id]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e == cudaSuccess) smem_attr[id] = smem;
  }
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = sms * (per_sm < cap ? per_sm : cap);
  cache[{id, key}] = *blocks;
  return cudaSuccess;
}

}  // namespace q8dot
