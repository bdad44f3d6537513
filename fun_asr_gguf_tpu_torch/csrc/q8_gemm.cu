// K1's prefill GEMM (m > 16) for Hopper (sm_90a):
//
//   y[m, n] = bf16(x[m, k]) . bf16(q[n, k] * d[n, k/32])^T, f32 sums,
//   written as f32 or bf16
//
// Replaces the Pallas kernel fun_asr_gguf_tpu/ops/quant_matmul.py
// quant_matmul / _quant_matmul_impl (:176, :206; and the layer-indexed
// forms, :303) above 16 rows of x: the prefill's projections. Numerics as
// K1's decode-sized kernel (q8_matmul.cu): the product q*d formed in f32
// and rounded to bf16 once, bf16 x, f32 sums; the kernel differs from the
// plain version only in summation order.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <set>
#include <utility>

#include "q8_slab.cuh"
#include "wgmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// The prefill GEMM (m > 16): warpgroup MMA, the weight as A in registers
// ---------------------------------------------------------------------------
//
// What bounds it: at the prefill buckets (m = 256, 512) the product sits
// near the card's ridge: qkv at m = 256 is 2.15 GFLOP (2.2 us at 989
// TFLOP/s) against 4.7 MB of weight, 0.5 MB of x and 2 MB of bf16 output
// (2.2 us at 3.35 TB/s). The mma.sync kernel this replaces (one 64 x 64
// tile a 128-thread block, synchronous loads, two __syncthreads and eight
// mma.sync a warp per 32-wide k step) waited out every step's loads.
//
// Design:
// - Transposed and weight-stationary: a block computes y^T = W . x^T for
//   128 weight rows (two consumer warpgroups of 64) against a panel of NP
//   rows of x (NP = 64 or 128, one wgmma's N; more rows take more panels,
//   the grid's z). The dequantized weight is wgmma's A operand, in
//   registers: each thread dequantizes its fragment (rows 16 w + g and + 8,
//   columns 2 t, 2 t + 1, 2 t + 8, 2 t + 9 of a k16 step) straight from
//   the int8 tile, q * d in f32 rounded to bf16 once (q8_slab.cuh deq2),
//   its rows' scales loaded a stage ahead. x is the B operand, K-major as
//   it is stored, from shared memory in the 128-byte swizzle.
// - A ring of as many stages as shared memory holds (x tile and int8
//   weight tile, 64 columns each), fed by TMA from a producer warp: rows
//   past m and n and columns past k arrive as zeros (k % 64 == 32 ends on
//   half a stage). A stage's mbarrier completes when its bytes have
//   landed, a second one when the consumer warps' wgmma group that read it
//   has completed; the two warpgroups' stages interleave on the tensor
//   cores.
// - k split over a thread-block cluster where the weight rows alone
//   cannot fill the card (o and down, n = 1024: 8 row tiles; the split
//   from ops/quant_matmul.py q8_gemm_plan): block c owns x rows [c NP / S,
//   (c + 1) NP / S) of the panel; each block stages its f32 partial tile
//   in its own shared memory and pushes the rows each other block owns,
//   as whole rows, into that block's receive slots beside its ring; after
//   a cluster barrier the owner adds the S partials in rank order: no
//   atomics, the result repeats bit for bit.
// - The epilogue writes the output type: f32 for the JAX signature, or
//   bf16 rounded to nearest even from the same f32 sums (the decoder's
//   projections), equal bit for bit to the f32 result's cast.
// - Parameters are read into registers and shared memory is addressed
//   through the __shared__ array: a reference to the __grid_constant__
//   parameter, or a pointer rebuilt from an integer, made every such
//   access a generic one, and cost the epilogue about a memory round trip
//   an item. Measured alternatives that were no faster: the weight
//   dequantized into shared memory (both wgmma operands there), by the
//   consumers or by a warpgroup of its own; the next stage dequantized
//   into a second fragment buffer under this stage's group; x panels of
//   192 or 256 rows (PERF.md §6).
namespace gemm {

constexpr int kRows = 128;                 // weight rows of a block
constexpr int kStep = 64;                  // k columns of a stage
constexpr int kSmem = 226 * 1024;          // of the card's 227 KB a block
constexpr int kConsumerThreads = 256;      // two warpgroups
constexpr int kThreads = kConsumerThreads + 32;   // and the producer warp
constexpr int kProducerWarp = kConsumerThreads / 32;
constexpr int kOStride = kRows + 4;        // floats of a partial row
constexpr int kMaxSplits = 8;              // portable cluster size

template <int NP>
struct Layout {
  static constexpr int kX = NP * 128;              // x: NP rows, swizzled
  static constexpr int kW = kRows * kStep;         // int8 weight rows
  static constexpr int kStage = kX + kW;
  // the partial tile [NP x rows][kRows weight rows]: the block's own,
  // staged over the ring after the last stage, and the receive slots of
  // the other splits' partials of the x rows it owns, beside the ring
  // (another block may push into them while this one still computes)
  static constexpr int kOut = NP * kOStride * 4;
  // as deep a ring as shared memory holds beside them, at most 8 stages
  // (6 at NP = 128, 8 at 64): a stage's bytes take about a microsecond to
  // land
  static constexpr int kStages = (kSmem - 2048 - kOut) / kStage < 8
                                     ? (kSmem - 2048 - kOut) / kStage : 8;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kBars = kRing + kOut;
  static constexpr int kBytes = kBars + 2 * kStages * 8 + 1024;
  static_assert(kStage % 1024 == 0, "stages keep the swizzle's alignment");
  static_assert(kOut <= kRing, "the block's partials fit over the ring");
  static_assert(kBytes <= kSmem, "the ring fits in shared memory");
};

struct Args {
  CUtensorMap x;            // bf16 [m, k]: boxes of NP rows x 64 columns
  CUtensorMap q;            // int8 [n, k]: boxes of 128 rows x 64 columns
  const float* d;           // [n, k / 32]
  void* y;                  // [m, n], f32 or bf16
  int m, n, k, out_bf16, stages_per_split;
};

template <int NP>
__device__ __forceinline__ void mma_x(float (&acc)[NP / 2],
                                      const unsigned (&a)[4], uint64_t b) {
  if constexpr (NP == 64)
    wg::mma_rs_n64<0>(acc, a, b, 1);
  else
    wg::mma_rs_n128<0>(acc, a, b, 1);
}

// the scales of weight rows ra, rb for the two q8_0 blocks of stage `st`
// (0 past n or k). The kernels copy their parameters to registers and
// pass them by value: a reference to the __grid_constant__ parameter
// makes each read a generic load.
__device__ __forceinline__ float4 stage_scales(const float* d, int n, int k,
                                               int n0, int ra, int rb,
                                               int st) {
  const int nb = k >> 5, b0 = 2 * st;
  auto at = [&](int r, int blk) {
    return n0 + r < n && blk < nb
               ? __ldg(d + static_cast<size_t>(n0 + r) * nb + blk)
               : 0.f;
  };
  return make_float4(at(ra, b0), at(ra, b0 + 1), at(rb, b0), at(rb, b0 + 1));
}

// One consumer stage: wait for stage `it`, dequantize this thread's A
// fragments of its four k16 steps (rows ra, rb of the block, scales sc:
// ra's two blocks, then rb's), and issue the four wgmma on them as one
// group.
template <int NP>
__device__ __forceinline__ void consume(float (&acc)[NP / 2],
                                        unsigned char* sm, uint64_t* full,
                                        int it, int ra, int rb, int t,
                                        float4 sc) {
  using L = Layout<NP>;
  const int slot = it % L::kStages;
  wg::bar_wait(&full[slot], (it / L::kStages) & 1);
  const unsigned char* st = sm + slot * L::kStage;
  const unsigned char* ws = st + L::kX;
  const unsigned lo = 0x7540u + 2 * (t & 1);   // bytes 2 (t % 2) and + 1
  const bool odd = t >> 1;                     // words 1 and 3 of a chunk
  unsigned fa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint4 wa = *reinterpret_cast<const uint4*>(ws + ra * kStep + kk * 16);
    const uint4 wb = *reinterpret_cast<const uint4*>(ws + rb * kStep + kk * 16);
    const float sa = kk < 2 ? sc.x : sc.y, sb = kk < 2 ? sc.z : sc.w;
    fa[kk][0] = deq2((odd ? wa.y : wa.x) ^ 0x80808080u, lo, lo + 1, sa);
    fa[kk][1] = deq2((odd ? wb.y : wb.x) ^ 0x80808080u, lo, lo + 1, sb);
    fa[kk][2] = deq2((odd ? wa.w : wa.z) ^ 0x80808080u, lo, lo + 1, sa);
    fa[kk][3] = deq2((odd ? wb.w : wb.z) ^ 0x80808080u, lo, lo + 1, sb);
  }
  wg::reg_fence(acc);
  wg::mma_fence();
  const unsigned xs = wg::smem_u32(st);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    mma_x<NP>(acc, fa[kk], wg::desc(xs + kk * 32, 16, 1024));
  wg::mma_commit();
}

// y[row, col .. col + 3] (as far as n) from the f32 sums, in y's type
__device__ __forceinline__ void store4(void* out, int n, bool bf16, int row,
                                       int col, float4 s) {
  const size_t o = static_cast<size_t>(row) * n + col;
  const bool whole = (n & 3) == 0;   // then col + 3 < n, aligned
  if (bf16) {
    __nv_bfloat16* y = static_cast<__nv_bfloat16*>(out) + o;
    const __nv_bfloat162 lo2 = __floats2bfloat162_rn(s.x, s.y);
    const __nv_bfloat162 hi2 = __floats2bfloat162_rn(s.z, s.w);
    if (whole) {
      *reinterpret_cast<uint2*>(y) =
          make_uint2(*reinterpret_cast<const unsigned*>(&lo2),
                     *reinterpret_cast<const unsigned*>(&hi2));
    } else {
      const __nv_bfloat16 v[4] = {lo2.x, lo2.y, hi2.x, hi2.y};
      for (int e = 0; e < 4 && col + e < n; ++e) y[e] = v[e];
    }
  } else {
    float* y = static_cast<float*>(out) + o;
    if (whole) {
      *reinterpret_cast<float4*>(y) = s;
    } else {
      const float v[4] = {s.x, s.y, s.z, s.w};
      for (int e = 0; e < 4 && col + e < n; ++e) y[e] = v[e];
    }
  }
}

template <int NP>
__global__ void __launch_bounds__(kThreads, 1)
q8_gemm_kernel(const __grid_constant__ Args a) {
  using L = Layout<NP>;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned for the swizzle, and derived from the __shared__
  // array so that its accesses compile to shared-memory instructions
  unsigned char* sm =
      smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  constexpr int kStages = L::kStages;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x, splits = gridDim.x;
  const int n0 = blockIdx.y * kRows, p0 = blockIdx.z * NP;
  const int m = a.m, n = a.n, k = a.k;
  const float* const d = a.d;
  const int nst = (k + kStep - 1) / kStep;
  const int s0 = split * a.stages_per_split;
  const int ns = max(0, min(nst, s0 + a.stages_per_split) - s0);
  const unsigned base = wg::smem_u32(sm);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      wg::bar_init(&full[s], 1);       // the producer's expect
      wg::bar_init(&empty[s], 8);      // the consumer warps
    }
    wg::bar_init_fence();
  }
  __syncthreads();
  if (splits > 1) wg::cluster_arrive();   // waited on before the pushes

  const int g = lane >> 2, t = lane & 3;
  const int ra = (warp >> 2) * 64 + (warp & 3) * 16 + g, rb = ra + 8;
  float acc[NP / 2];
  if (warp == kProducerWarp) {
    if (lane == 0) {
      for (int it = 0; it < ns; ++it) {
        const int slot = it % kStages;
        if (it >= kStages) {
          wg::bar_wait(&empty[slot], (it / kStages - 1) & 1);
          wg::fence_async_smem();
        }
        const unsigned xs = base + slot * L::kStage;
        const int c0 = (s0 + it) * kStep;
        wg::bar_expect(&full[slot], L::kStage);
        wg::tma_2d(xs, &a.x, c0, p0, &full[slot]);
        wg::tma_2d(xs + L::kX, &a.q, c0, n0, &full[slot]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) acc[i] = 0.f;
    // a group's wgmma read its fragment registers while in flight, so
    // each stage's group completes before the next stage's dequant
    float4 sc = stage_scales(d, n, k, n0, ra, rb, s0);
    for (int it = 0; it < ns; ++it) {
      const float4 cur = sc;
      if (it + 1 < ns) sc = stage_scales(d, n, k, n0, ra, rb, s0 + it + 1);
      consume<NP>(acc, sm, full, it, ra, rb, t, cur);
      wg::mma_wait<0>();
      wg::reg_fence(acc);
      if (lane == 0) wg::bar_arrive(&empty[it % kStages]);
    }
  }

  // The block's partial tile, [x row][weight row], over the ring. Block c
  // owns x rows [c per, (c + 1) per) of the panel: each block pushes the
  // rows every other block owns into that block's receive slot for it,
  // and after a cluster barrier each adds its rows' splits in rank order.
  const int per = NP / splits;
  float* po = reinterpret_cast<float*>(sm);
  __syncthreads();                     // the ring is free
  if (warp != kProducerWarp) {
#pragma unroll
    for (int j = 0; j < NP / 8; ++j) {
      const int xr = 8 * j + 2 * t;
      po[xr * kOStride + ra] = acc[4 * j];
      po[(xr + 1) * kOStride + ra] = acc[4 * j + 1];
      po[xr * kOStride + rb] = acc[4 * j + 2];
      po[(xr + 1) * kOStride + rb] = acc[4 * j + 3];
    }
  }
  __syncthreads();                     // staged
  if (splits > 1) {
    wg::cluster_wait();                // every block has started
    for (int q = 0; q < splits; ++q) {
      if (q == split) continue;
      const int slot = split < q ? split : split - 1;   // q's slot for us
      wg::push(wg::remote(base + L::kRing + slot * per * kOStride * 4, q),
               reinterpret_cast<const float4*>(po + q * per * kOStride),
               per * kOStride / 4, tid, kThreads);
    }
    wg::cluster_sync();                // the partials have landed
  }
  void* const y = a.y;
  const bool bf16 = a.out_bf16 != 0;
  const float* pr = reinterpret_cast<const float*>(sm + L::kRing);
  constexpr int kCols = kRows / 4;     // float4 of a partial row
#pragma unroll 4
  for (int i = tid; i < per * kCols; i += kThreads) {
    const int xr = i / kCols, c = (i % kCols) * 4;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < splits; ++q) {
      const float* row = q == split ? po + (split * per + xr) * kOStride
                                    : pr + ((q < split ? q : q - 1) * per
                                            + xr) * kOStride;
      const float4 v = *reinterpret_cast<const float4*>(row + c);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const int row = p0 + split * per + xr, col = n0 + c;
    if (row < m && col < n) store4(y, n, bf16, row, col, s);
  }
}

std::mutex attr_mu;
std::set<std::pair<int, const void*>> attr_set;

template <int NP>
cudaError_t launch(const Args& a, int panels, int splits, cudaStream_t s) {
  const void* kernel = reinterpret_cast<const void*>(q8_gemm_kernel<NP>);
  const int smem = Layout<NP>::kBytes;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  {
    std::lock_guard<std::mutex> lock(attr_mu);
    if (!attr_set.count({dev, kernel})) {
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
      if (e != cudaSuccess) return e;
      attr_set.insert({dev, kernel});
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (a.n + kRows - 1) / kRows, panels);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, q8_gemm_kernel<NP>, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace gemm

}  // namespace

// K1's prefill GEMM: x bf16 [m, k]; q int8 [n, k]; d f32 [n, k/32]; y [m,
// n], bf16 when out_bf16 else f32. k % 32 == 0; x, q, d 16-byte aligned
// (checked by the wrapper). The plan (ops/quant_matmul.py q8_gemm_plan):
// x panels of `np` rows (64 or 128; ceil(m / np) of them) and k
// split over `splits` blocks of a cluster (1, 2, 4 or 8).
extern "C" int q8_gemm(const void* x, const void* q, const void* d, void* y,
                       int m, int n, int k, int out_bf16, int np, int splits,
                       void* stream) {
  if (m < 1 || n < 1 || k < 32 || k % 32 || (np != 64 && np != 128)
      || splits < 1 || splits > gemm::kMaxSplits || (splits & (splits - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nst = (k + gemm::kStep - 1) / gemm::kStep;
  gemm::Args a{};
  {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k),
                                static_cast<cuuint64_t>(m)};
    const cuuint64_t bytes[1] = {static_cast<cuuint64_t>(k) * 2};
    const cuuint32_t box[2] = {gemm::kStep, static_cast<cuuint32_t>(np)};
    const int e = wg::tensor_map(&a.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                 x, dims, bytes, box,
                                 CU_TENSOR_MAP_SWIZZLE_128B);
    if (e) return e;
  }
  {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k),
                                static_cast<cuuint64_t>(n)};
    const cuuint64_t bytes[1] = {static_cast<cuuint64_t>(k)};
    const cuuint32_t box[2] = {gemm::kStep, gemm::kRows};
    const int e = wg::tensor_map(&a.q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, q,
                                 dims, bytes, box,
                                 CU_TENSOR_MAP_SWIZZLE_NONE);
    if (e) return e;
  }
  a.d = static_cast<const float*>(d);
  a.y = y;
  a.m = m;
  a.n = n;
  a.k = k;
  a.out_bf16 = out_bf16 ? 1 : 0;
  a.stages_per_split = (nst + splits - 1) / splits;
  const int panels = (m + np - 1) / np;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (np == 64) return static_cast<int>(gemm::launch<64>(a, panels, splits, s));
  return static_cast<int>(gemm::launch<128>(a, panels, splits, s));
}
