// The block shape of the q8_0 kernels and the warp reductions that the
// path kernels' headers (q8_stream.cuh, split_kv.cuh) and q8_decode_all.cu
// share with the probes' GEMV (q8_gemv.cuh).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace q8 {

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

}  // namespace q8
