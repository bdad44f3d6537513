// K6 — q8_0 x q8_0 block-dot matmul for Hopper (sm_90a), decode sized.
//
//   y[r, j] = sum_b float(q8(x)[r, b] . q[j, b]) * d[j, b] * xs[r, b]   (f32)
//
// for x [m, k] f32 with 1 <= m <= 16 and a natural-k q8_0 weight q [n, k]
// int8 + d [n, k/32] f32. Replaces the Pallas kernel
// fun_asr_gguf_tpu/ops/quant_matmul.py q8dot_matmul (:1416; body
// _q8dot_kernel :1393, _q8dot_tile :1381, the block-diagonal expansion
// _build_x_diag :1352 / _build_gx :1369, activation quantization
// quantize_act_q8 :1340). Numerics are llama.cpp's q8_0 x q8_0 vec_dot
// contract, as JAX's reference _q8dot_ref (:1399) states it: the
// activations are quantized to q8_0 per 32-block, s8 x s8 partials are
// exact in int32, both block scales multiply the partial, the partials are
// summed in f32 (q8_dot.cuh).
//
// What bounds it: bytes. The weight is read once: n*k int8 plus n*k/32 f32
// scales, 1.125 bytes per weight; the lm_head (n = 152576, k = 1024) is
// 175.8 MB, a 0.0525 ms floor at the H100's 3.35 TB/s. The integer work
// (2*m*n*k operations) is far below the int8 peak at m <= 16.
//
// Design. The TPU kernel expands the activations into a block-diagonal
// matrix so that one MXU dot yields every block partial; on Hopper a lane
// takes the block partial itself with eight dp4a. Every block quantizes the
// m activation rows into its own shared memory once (m*k int8 + m*k/32
// scales: 18 KB at m = 16, k = 1024) — cheaper than a second launch — and
// its warps then walk output rows: one warp per row for all m activation
// rows, each lane one 32-byte q8_0 block (two 16-byte loads) and its scale,
// so a warp reads 1 KB of a row at once and each weight byte crosses the
// bus once for all m rows. The grid is the card's co-resident block count
// (occupancy query, cached), capped by the rows there are.

#include <cuda_runtime.h>
#include <stdint.h>

#include "q8_dot.cuh"

namespace {

using namespace q8dot;

constexpr int kMaxBlocksPerSm = 8;

__host__ __device__ constexpr size_t smem_bytes(int m, int k) {
  return static_cast<size_t>(m) * k + static_cast<size_t>(m) * (k / 32) * 4;
}

template <int MT>
__global__ void __launch_bounds__(kThreads)
q8dot_kernel(const float* __restrict__ x, const int8_t* __restrict__ wq,
             const float* __restrict__ wd, float* __restrict__ y, int m,
             int n, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* xq = reinterpret_cast<int8_t*>(smem_raw);                // [m, k]
  float* xs = reinterpret_cast<float*>(smem_raw + m * k);          // [m, k/32]
  quant_rows_to_smem(
      [&](int r, int c) { return __ldg(x + static_cast<size_t>(r) * k + c); },
      m, k, xq, xs);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int nwarps = gridDim.x * kWarps;
  for (int j = gwarp; j < n; j += nwarps) {
    const int8_t* const q[1] = {wq + static_cast<size_t>(j) * k};
    const float* const d[1] = {wd + static_cast<size_t>(j) * (k >> 5)};
    float acc[1][MT] = {};
    dot_rows<MT, 1>(q, d, xq, xs, m, k, lane, acc);
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      if (r < m) {
        const float v = warp_sum(acc[0][r]);
        if (lane == 0) y[static_cast<size_t>(r) * n + j] = v;
      }
    }
  }
}

template <int MT>
cudaError_t launch(const float* x, const int8_t* wq, const float* wd,
                   float* y, int m, int n, int k, cudaStream_t stream) {
  int dev = 0, blocks = 0;
  cudaError_t e = cudaGetDevice(&dev);
  // sized for the largest m this instance serves, so any m <= MT fits
  if (e == cudaSuccess)
    e = grid_blocks(q8dot_kernel<MT>, dev, k, smem_bytes(MT, k),
                    kMaxBlocksPerSm, &blocks);
  if (e != cudaSuccess) return e;
  const int rows_blocks = (n + kWarps - 1) / kWarps;
  if (blocks > rows_blocks) blocks = rows_blocks;
  q8dot_kernel<MT><<<blocks, kThreads, smem_bytes(m, k), stream>>>(
      x, wq, wd, y, m, n, k);
  return cudaGetLastError();
}

}  // namespace

// x: f32 [m, k]; wq: int8 [n, k]; wd: f32 [n, k/32]; y: f32 [m, n].
// 1 <= m <= 16, k % 32 == 0, 16-byte aligned pointers (checked by the
// wrapper). Returns the launch's cudaError_t.
extern "C" int q8dot_matmul(const void* x, const void* wq, const void* wd,
                            void* y, int m, int n, int k, void* stream) {
  if (m < 1 || m > 16 || n < 1 || k < 32 || k % 32 ||
      smem_bytes(16, k) > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xp = static_cast<const float*>(x);
  const int8_t* q = static_cast<const int8_t*>(wq);
  const float* d = static_cast<const float*>(wd);
  float* yp = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 1) return static_cast<int>(launch<1>(xp, q, d, yp, m, n, k, s));
  if (m <= 4) return static_cast<int>(launch<4>(xp, q, d, yp, m, n, k, s));
  return static_cast<int>(launch<16>(xp, q, d, yp, m, n, k, s));
}
