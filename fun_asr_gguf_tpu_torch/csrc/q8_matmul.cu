// K1 — q8_0 dequant-matmul, and K6 — the q8_0 x q8_0 block-dot product, for
// Hopper (sm_90a).
//
//   K1: y[m, n] (f32) = bf16(x[m, k]) . bf16(q[n, k] * d[n, k/32])^T
//   K6: y[r, j] (f32) = sum_b float(q8(x)[r, b] . q[j, b]) * d[j, b] * xs[r, b]
//
// Replace the Pallas kernels fun_asr_gguf_tpu/ops/quant_matmul.py
// quant_matmul / _quant_matmul_impl (:176, :206; and the layer-indexed
// forms: a layer of a stacked [L, n, k] weight is a pointer offset here) and
// q8dot_matmul (:1416; body _q8dot_kernel :1393 with the block-diagonal
// expansion _build_x_diag :1352, activation quantization quantize_act_q8
// :1340). K1's numerics follow the JAX reference path (_quant_matmul_impl
// with tile_n == 0): the product q*d is formed in f32 and rounded to bf16
// ONCE; x arrives in bf16. (The Pallas body rounds d to bf16 before the
// multiply — a double rounding this port does not copy.) bf16 x bf16
// products are exact in f32, so the kernel differs from the plain version
// only in summation order. K6's are llama.cpp's q8_0 x q8_0 vec_dot, as
// JAX's reference _q8dot_ref (:1399) states it (q8_slab.cuh): x [m, k] f32
// quantized to q8_0 per 32-block in the kernel, exact int32 block
// partials, both block scales, f32 sums.
//
// Two kernels:
//  * m <= 16 (decode m = 1, a verify round m = 9, and every projection of
//    the q8_0 route without the fused chain): q8_matvec_kernel, one kernel
//    under the two dot contracts (template argument kI8, as K4 and K7 are
//    one kernel in q8_layer_fused.cu), on the streaming weight engine
//    (q8_stream.cuh, q8_slab.cuh).
//  * m > 16 (prefill, K1 only): q8_gemm.cu, on warpgroup MMA.
//
// What bounds q8_matvec_kernel: bytes. The weight is read once, n k int8
// plus n k / 32 f32 scales, 1.125 bytes a weight: the 152576 x 1024
// lm_head is 175.8 MB, a 0.0525 ms floor at the H100's 3.35 TB/s, at m = 1
// and m = 9 alike; the operations (2 m n k) stay far below either tensor
// core peak at m <= 16.
//
// Design. The warp-per-row forms it replaces (K1's q8_gemv_kernel, K6's
// q8dot_kernel) read each weight row with 16-byte __ldg by the warps that
// computed, so every warp waited on DRAM latency, and re-read every
// activation row (K1: from global memory, for each 16 weights) or ran
// dp4a once per activation row (K6): at m = 9 the same bytes took ~2.8x
// their m = 1 time. Here:
// - Each block takes a contiguous range of whole rows (block b: rows
//   [b n / blocks, (b + 1) n / blocks), counts differ by at most one) on the
//   card's co-resident grid. It is a plain launch: no block needs
//   another's output.
// - The rows arrive as a ring of R-row tiles in shared memory (int8 rows,
//   then their f32 scales; R, the ring's depth, the blocks an SM and the
//   layout from ops/quant_matmul.py q8_matvec_split). The first tiles are
//   requested by bulk copies in the launch's first instructions, by the
//   last thread (q8s::request), so that the activation rows' loads leave
//   beside them and not behind them; a slot again only after the
//   __syncthreads that ends its reads, by thread 0 (fetch; its
//   fence.proxy.async orders those reads before the copy). Where k is not
//   a multiple of 128 the scales go by plain loads beside the bulk copy
//   (fetch, from the first tiles on).
// - The activation rows are loaded once per block into shared memory while
//   the first tiles are on their way: K1 bf16 rows padded by 16 bytes
//   (load_rows), K6 q8_0 rows quantized in the block with quantize_act_q8's
//   IEEE arithmetic (quant_rows). Every m, m = 1 included, takes the
//   tensor cores: K1 mma.sync m16n8k16 on the bf16 rows with each weight
//   dequantized once for all m rows, K6 m16n8k32 s8, one mma a q8_0 block
//   (the fragments of K4's and K7's mma_slab / mma_slab_i8). Where m rows
//   of k columns do not fit beside the ring, they are taken in column
//   chunks, again for every tile.
// - The eight warps' items of a tile are its 8-row subtiles (one mma's
//   weight rows), each cut into as even slices of its 64-column spans as
//   make eight items (the head's 32-row tiles: two slices a subtile; o and
//   down, 7-8 rows a block: eight), so every warp has work whatever the
//   rows. The slices' partial tiles meet in shared memory (two buffers,
//   alternate tiles in the other, so one __syncthreads a tile both
//   publishes them and frees the slot) and are added in slice order, by
//   the last warps, while thread 0 requests the slot's next tile.
// - Why not K4's mma_slab itself: its four 8-row tiles' mma chain on one
//   accumulator each, one tile after the other, so a warp waited on each
//   mma's latency, and its per-tile reduction and stores cost as much
//   again: streaming the head, the warps, not the bytes, set the time
//   (PERF.md §6). Here each of a span's four mma steps has its own
//   accumulator (K6: each of its two blocks), added in a fixed order at
//   the end, so repeated calls are equal bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>
#include <utility>

#include "q8_slab.cuh"
#include "q8_stream.cuh"

namespace {

// ---------------------------------------------------------------------------
// The decode-sized product (m <= 16), both contracts
// ---------------------------------------------------------------------------

enum Mode { kLo = 0, kHi };   // m = 1..8, 9..16: activation rows g (, g + 8)
// the layout's ints (ops/quant_matmul.py K1_LAYOUT, in this order): byte
// offsets of the activation rows, the two partial-sum buffers, the
// mbarriers and the ring; bytes of a ring slot; rows of a tile; the ring's
// depth; the activation chunk's columns and bytes a row
enum Lay {
  kX = 0, kRed, kBars, kRing, kSlot, kRows, kDepth, kXcols, kXstride,
  kLayoutLen
};
constexpr int kMaxBlocksPerSm = 2;

struct Layout {
  int v[kLayoutLen];
};

struct Args {
  const void* x;    // K1: bf16 [m, k]; K6: f32 or (x_bf16) bf16 [m, k]
  const int8_t* q;  // [n, k]
  const float* d;   // [n, k / 32]
  float* y;         // [m, n]
  int m, n, k, blocks;
  Layout lay;
  int x_bf16;
};

// K1: lane (g, t)'s share of one weight row's products (wq: its int8
// bytes, wd: its f32 block scales, in a ring slot) with activation rows g
// and g + 8 (x0, x1: bf16 rows, column c0 first) over the 64-column spans
// [a, b) of columns [c0, c1): K4's mma fragments (q8_layer_fused.cu
// mma_slab: lane t takes columns 16 t .. 16 t + 15 of a span of weight row
// g, four m16n8k16 steps of 4 columns, each weight dequantized once), with
// each step in its own accumulator c[st] so that consecutive mma do not
// wait on each other, and the loads of the next span under this one's.
template <bool kHiRows>
__device__ __forceinline__ void span_dot(const unsigned char* wq,
                                         const float* wd, int a, int b,
                                         int c0, int c1,
                                         const unsigned char* x0,
                                         const unsigned char* x1, bool has0,
                                         bool has1, int t,
                                         float (&c)[4][4]) {
#pragma unroll 2
  for (int sp = a; sp < b; ++sp) {
    const int col = sp * kSpan + 16 * t;
    const bool in = col < c1;   // k % 32 == 0: 16 columns all in or out
    uint4 qv = make_uint4(0u, 0u, 0u, 0u);
    uint4 xa = qv, xb = qv, ya = qv, yb = qv;
    float s = 0.f;
    const int xo = (col - c0) * 2;
    if (in) {
      qv = *reinterpret_cast<const uint4*>(wq + col);
      s = wd[col >> 5];
      if (has0) {
        xa = *reinterpret_cast<const uint4*>(x0 + xo);
        xb = *reinterpret_cast<const uint4*>(x0 + xo + 16);
      }
      if (kHiRows && has1) {
        ya = *reinterpret_cast<const uint4*>(x1 + xo);
        yb = *reinterpret_cast<const uint4*>(x1 + xo + 16);
      }
    }
    const unsigned A0[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
    const unsigned A1[8] = {ya.x, ya.y, ya.z, ya.w, yb.x, yb.y, yb.z, yb.w};
    const unsigned w[4] = {qv.x ^ 0x80808080u, qv.y ^ 0x80808080u,
                           qv.z ^ 0x80808080u, qv.w ^ 0x80808080u};
#pragma unroll
    for (int st = 0; st < 4; ++st)   // columns 16 t + 4 st .. + 3
      mma16816(c[st], A0[2 * st], A1[2 * st], A0[2 * st + 1],
               A1[2 * st + 1], deq2(w[st], 0x7540, 0x7541, s),
               deq2(w[st], 0x7542, 0x7543, s));
  }
}

// K6: lane (g, t)'s share of the products of weight rows g (wq: its int8
// bytes; w0d, w1d: the f32 block scales of rows 2 t and 2 t + 1) with the
// q8_0 activation rows g and g + 8 (x0, x1: int8 rows at the lane's byte
// offset, column c0 first; xs: their scales, [block of the chunk][kHi ? 16
// : 8]) over the spans [a, b) of columns [c0, c1): K7's s8 fragments
// (q8_layer_fused.cu mma_slab_i8: one m16n8k32 mma a q8_0 block, lanes t
// and t ^ 2 swap halves of a 16-byte load), its exact int32 partial scaled
// by d_w d_x into the span's first block's accumulator c[0] or its second
// one's c[1].
template <bool kHiRows>
__device__ __forceinline__ void span_dot_i8(const unsigned char* wq,
                                            const float* w0d,
                                            const float* w1d, int a, int b,
                                            int c0, int c1,
                                            const unsigned char* x0,
                                            const unsigned char* x1,
                                            const float* xs, bool has0,
                                            bool has1, int g, int t,
                                            float (&c)[2][4]) {
  constexpr int kBs = kHiRows ? 16 : 8;   // scales a block
  const bool lo = t < 2;
#pragma unroll 2
  for (int sp = a; sp < b; ++sp) {
    const int col = sp * kSpan, blk = col >> 5;
    const bool two = col + 32 < c1;   // the span's second block is in
    const int xc = col - c0;
    uint2 xa = make_uint2(0u, 0u), xb = xa, ya = xa, yb = xa;
    float sa = 0.f, sb = 0.f, ta = 0.f, tb = 0.f;   // d_x: rows g, g + 8
    const float* xsb = xs + (xc >> 5) * kBs;
    if (has0) {
      xa = *reinterpret_cast<const uint2*>(x0 + xc);
      sa = xsb[g];
      if (two) {
        xb = *reinterpret_cast<const uint2*>(x0 + xc + 32);
        sb = xsb[kBs + g];
      }
    }
    if (kHiRows && has1) {
      ya = *reinterpret_cast<const uint2*>(x1 + xc);
      ta = xsb[g + 8];
      if (two) {
        yb = *reinterpret_cast<const uint2*>(x1 + xc + 32);
        tb = xsb[kBs + 8 + g];
      }
    }
    uint4 q = make_uint4(0u, 0u, 0u, 0u);
    if (lo || two) q = *reinterpret_cast<const uint4*>(wq + col + 16 * t);
    const float w0 = w0d[blk], w1 = w1d[blk];
    const float v0 = two ? w0d[blk + 1] : 0.f, v1 = two ? w1d[blk + 1] : 0.f;
    const unsigned s0 = lo ? q.z : q.x, s1 = lo ? q.w : q.y;
    const unsigned r0 = __shfl_xor_sync(0xffffffffu, s0, 2);
    const unsigned r1 = __shfl_xor_sync(0xffffffffu, s1, 2);
    // z[0], z[1]: activation row g, weight rows 2t, 2t + 1; z[2], z[3]:
    // activation row g + 8
    int z[4], u[4];
    mma_s8(z, xa.x, ya.x, xa.y, ya.y, lo ? q.x : r0, lo ? q.y : r1);
    if (two)   // warp-uniform
      mma_s8(u, xb.x, yb.x, xb.y, yb.y, lo ? r0 : q.z, lo ? r1 : q.w);
    c[0][0] = fmaf(i2f_exact(z[0]) * w0, sa, c[0][0]);
    c[0][1] = fmaf(i2f_exact(z[1]) * w1, sa, c[0][1]);
    if (kHiRows) {
      c[0][2] = fmaf(i2f_exact(z[2]) * w0, ta, c[0][2]);
      c[0][3] = fmaf(i2f_exact(z[3]) * w1, ta, c[0][3]);
    }
    if (two) {
      c[1][0] = fmaf(i2f_exact(u[0]) * v0, sb, c[1][0]);
      c[1][1] = fmaf(i2f_exact(u[1]) * v1, sb, c[1][1]);
      if (kHiRows) {
        c[1][2] = fmaf(i2f_exact(u[2]) * v0, tb, c[1][2]);
        c[1][3] = fmaf(i2f_exact(u[3]) * v1, tb, c[1][3]);
      }
    }
  }
}

template <int kMode, bool kI8>
__global__ void __launch_bounds__(kThreads, kMaxBlocksPerSm)
q8_matvec_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kHiRows = kMode == kHi;
  constexpr int kStride = kHiRows ? 128 : 64;   // floats of a partial tile
  constexpr int kBs = kHiRows ? 16 : 8;         // K6: scales a block
  const int m = a.m, n = a.n, k = a.k;
  // rows [b n / blocks, (b + 1) n / blocks), in 32 bits where n blocks
  // fits (the 64-bit division costs the first request some hundred cycles)
  auto start = [&](unsigned b) {
    const unsigned nn = static_cast<unsigned>(n);
    const unsigned nb = static_cast<unsigned>(a.blocks);
    return nn <= 0xffffffffu / nb
               ? static_cast<long long>(b * nn / nb)
               : static_cast<long long>(static_cast<unsigned long long>(b) *
                                        nn / nb);
  };
  const long long lo = start(blockIdx.x);
  const int here = static_cast<int>(start(blockIdx.x + 1) - lo);
  if (here == 0) return;   // the whole block: more blocks than rows
  const int R = a.lay.v[kRows], depth = a.lay.v[kDepth];
  const int tiles = (here + R - 1) / R;
  const size_t slot_bytes = a.lay.v[kSlot];
  unsigned char* X = smem + a.lay.v[kX];
  float* red = reinterpret_cast<float*>(smem + a.lay.v[kRed]);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + a.lay.v[kBars]);
  unsigned char* ring = smem + a.lay.v[kRing];
  const int xcols = a.lay.v[kXcols], xstride = a.lay.v[kXstride];
  // K6: the q8_0 rows' scales after the rows, block-major
  float* qs = reinterpret_cast<float*>(X + m * xstride);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int it = threadIdx.x >> 5;   // this warp's item of every tile
  const int ns = (k + kSpan - 1) / kSpan, nb = k >> 5;
  const bool has0 = g < m, has1 = kHiRows && g + 8 < m;
  // K6's fragments: lane t's bytes of a block at off(t) (span_dot_i8)
  const int off = kI8 ? 8 * (2 * (t & 1) + (t >> 1)) : 0;
  const unsigned char* x0 = X + g * xstride + off;
  const unsigned char* x1 = X + (g + 8) * xstride + off;

  // The first tiles go out before anything else, from the last thread
  // where the scales are whole 16-byte words (q8s::request), so that the
  // first threads' loads of the activation rows leave beside them, not
  // behind them; else from thread 0 with the block's plain loads of the
  // scales (fetch). Only that thread touches the mbarriers before the
  // __syncthreads that ends the first fill.
  const int first = min(depth, tiles);
  const bool bulk_d = k % 128 == 0;
  if (threadIdx.x == (bulk_d ? kThreads - 1 : 0)) {
    for (int s = 0; s < first; ++s) bar_init(bars + s);
    bar_init_fence();
    for (int s = 0; bulk_d && s < first; ++s)
      request(ring + s * slot_bytes, bars + s, a.q, a.d, k,
              static_cast<int>(lo) + s * R, min(R, here - s * R), 0);
  }
  for (int s = 0; !bulk_d && s < first; ++s)
    fetch(ring + s * slot_bytes, bars + s, a.q, a.d, k,
          lo + static_cast<size_t>(s) * R, min(R, here - s * R), 0);

  // columns [c0, c1) of the activation rows into shared memory
  auto fill = [&](int c0, int c1) {
    if constexpr (kI8) {
      if (a.x_bf16) {   // the f32 value of a bf16 is exact
        const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
        quant_rows([&](int r, int c) {
          const uint2 v = __ldg(reinterpret_cast<const uint2*>(
              x + static_cast<size_t>(r) * k + c));
          const float2 p = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&v.x));
          const float2 q = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&v.y));
          return make_float4(p.x, p.y, q.x, q.y);
        }, m, c0, c1, X, xstride, qs, kBs, 1);
      } else {
        const float* x = static_cast<const float*>(a.x);
        quant_rows([&](int r, int c) {
          return __ldg(reinterpret_cast<const float4*>(
              x + static_cast<size_t>(r) * k + c));
        }, m, c0, c1, X, xstride, qs, kBs, 1);
      }
    } else {
      load_rows(static_cast<const __nv_bfloat16*>(a.x), m, k, c0, c1, X,
                xstride);
    }
  };

  // The warps' eight items of a tile of `rows` rows: subtile `sub` of its
  // nsub 8-row subtiles takes items [f0, f1), item it its slice it - f0 of
  // the spans; (e0, e1): the items of the subtile of output row jo, the
  // row this thread sums in the tile's output loop (taken from the last
  // warp down, so thread 0, which requests the next tiles, has none while
  // a tile has at most 192 outputs). Full tiles share one.
  struct Item {
    int nsub, sub, sp_a, sp_b, e0, e1;
  };
  const int jo = (kThreads - 1 - threadIdx.x) & 63;
  const int ro = (kThreads - 1 - threadIdx.x) >> 6;
  auto item_of = [&](int rows) {
    Item w;
    w.nsub = (rows + 7) / 8;
    w.sub = it * w.nsub / kWarps;
    const int f0 = (w.sub * kWarps + w.nsub - 1) / w.nsub;
    const int f1 = ((w.sub + 1) * kWarps + w.nsub - 1) / w.nsub;
    w.sp_a = (it - f0) * ns / (f1 - f0);
    w.sp_b = (it - f0 + 1) * ns / (f1 - f0);
    w.e0 = ((jo >> 3) * kWarps + w.nsub - 1) / w.nsub;
    w.e1 = ((jo >> 3) * kWarps + kWarps + w.nsub - 1) / w.nsub;
    return w;
  };
  Item w = item_of(R);

  // the activation rows once (the first tiles in flight meanwhile), or a
  // column chunk at a time for every tile
  const bool chunked = xcols < k;
  int s = 0;
  unsigned phase = 0;
  for (int tt = 0; tt < tiles; ++tt) {
    const int r0 = tt * R, rows = min(R, here - r0);
    if (rows != R) w = item_of(rows);   // the last tile
    unsigned char* slot = ring + s * slot_bytes;
    float* rb = red + (tt & 1) * kWarps * kStride;
    const float* d = reinterpret_cast<const float*>(
        slot + static_cast<size_t>(rows) * k);
    // lanes past the tile's rows read its last row; their columns of the
    // fragment are never stored
    const int jg = min(w.sub * 8 + g, rows - 1);
    const unsigned char* wq = slot + static_cast<size_t>(jg) * k;
    float v[4];
    if constexpr (kI8) {
      float c[2][4] = {};
      const float* w0d = d + min(w.sub * 8 + 2 * t, rows - 1) * nb;
      const float* w1d = d + min(w.sub * 8 + 2 * t + 1, rows - 1) * nb;
      for (int c0 = 0; c0 < k; c0 += xcols) {
        const int c1 = min(k, c0 + xcols);
        if (chunked || tt == 0) {
          if (c0 > 0) __syncthreads();
          fill(c0, c1);
          __syncthreads();
        }
        if (c0 == 0) bar_wait(bars + s, phase);
        span_dot_i8<kHiRows>(wq, w0d, w1d, max(w.sp_a, c0 / kSpan),
                             min(w.sp_b, (c1 + kSpan - 1) / kSpan), c0, c1,
                             x0, x1, qs, has0, has1, g, t, c);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = c[0][e] + c[1][e];
    } else {
      float c[4][4] = {};
      const float* wd = d + jg * nb;
      for (int c0 = 0; c0 < k; c0 += xcols) {
        const int c1 = min(k, c0 + xcols);
        if (chunked || tt == 0) {
          if (c0 > 0) __syncthreads();
          fill(c0, c1);
          __syncthreads();
        }
        if (c0 == 0) bar_wait(bars + s, phase);
        span_dot<kHiRows>(wq, wd, max(w.sp_a, c0 / kSpan),
                          min(w.sp_b, (c1 + kSpan - 1) / kSpan), c0, c1, x0,
                          x1, has0, has1, t, c);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = (c[0][e] + c[1][e]) + (c[2][e] + c[3][e]);
    }
    // v[0], v[1]: activation row g, tile rows 8 sub + 2t, + 1; v[2], v[3]:
    // activation row g + 8: this slice's partial tile
    float* part = rb + it * kStride + g * 8 + 2 * t;
    part[0] = v[0];
    part[1] = v[1];
    if (kHiRows) {
      part[64] = v[2];
      part[65] = v[3];
    }
    __syncthreads();
    const int next = tt + depth;
    if (next < tiles)
      fetch(slot, bars + s, a.q, a.d, k, lo + static_cast<size_t>(next) * R,
            min(R, here - next * R), 0);
    if (jo < rows) {   // row jo: its subtile's slices, in order
      const float* src = rb + (jo & 7);
      for (int r = ro; r < m; r += kThreads / 64) {
        float sum = 0.f;
        for (int e = w.e0; e < w.e1; ++e) sum += src[e * kStride + r * 8];
        a.y[static_cast<size_t>(r) * n + lo + r0 + jo] = sum;
      }
    }
    if (++s == depth) {
      s = 0;
      phase ^= 1u;
    }
  }
}

using Kernel = void (*)(Args);

Kernel kernel_of(int mode, bool i8) {
  static const Kernel kernels[2][2] = {
      {q8_matvec_kernel<kLo, false>, q8_matvec_kernel<kHi, false>},
      {q8_matvec_kernel<kLo, true>, q8_matvec_kernel<kHi, true>}};
  return kernels[i8 ? 1 : 0][mode];
}

// the m class of a plan: 1, 2..8, 9..16, and the kernel that serves it
int class_of(int m) { return m == 1 ? 0 : m <= 8 ? 1 : 2; }
int mode_of(int m) { return m <= 8 ? kLo : kHi; }

// The plans the wrapper registers (q8_matvec_plan), one per (device, n, k,
// m class, contract); the shared-memory opt-in of each kernel, which only
// grows, per (device, kernel).
struct Plan {
  Layout lay;
  int blocks, smem;
};
std::mutex plan_mu;
std::map<std::tuple<int, int, int, int, bool>, Plan> plans;
std::map<std::pair<int, const void*>, int> smem_set;

cudaError_t launch_matvec(const void* x, const void* q, const void* d,
                          void* y, int m, int n, int k, bool i8, bool x_bf16,
                          cudaStream_t stream) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  Plan p;
  {
    std::lock_guard<std::mutex> lock(plan_mu);
    const auto it = plans.find(std::make_tuple(dev, n, k, class_of(m), i8));
    if (it == plans.end()) return cudaErrorInvalidValue;   // no plan
    p = it->second;
  }
  const int mode = mode_of(m);
  Args a{x, static_cast<const int8_t*>(q), static_cast<const float*>(d),
         static_cast<float*>(y), m, n, k, p.blocks, p.lay, x_bf16 ? 1 : 0};
  void* args[] = {&a};
  e = cudaLaunchKernel(reinterpret_cast<const void*>(kernel_of(mode, i8)),
                       dim3(p.blocks), dim3(kThreads), args, p.smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// Register the plan of the decode-sized product at (n, k, the m class of
// m, contract i8) on the current device: `layout` (host memory) holds the
// K1_LAYOUT ints of ops/quant_matmul.py q8_matvec_split for `blocks`
// blocks and `smem` bytes of dynamic shared memory. Writes the blocks the
// card can make co-resident at that shared memory (at most two an SM) to
// `most`, an int, and keeps the plan only when `blocks` fits. Returns a
// cudaError_t.
extern "C" int q8_matvec_plan(int n, int k, int m, int i8, const void* layout,
                              int blocks, int smem, void* most) {
  const int* v = static_cast<const int*>(layout);
  if (m < 1 || m > 16 || n < 1 || k < 32 || k % 32 || blocks < 1
      || smem < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const void* kernel =
      reinterpret_cast<const void*>(kernel_of(mode_of(m), i8 != 0));
  std::lock_guard<std::mutex> lock(plan_mu);
  int& set = smem_set[{dev, kernel}];
  if (smem > 48 * 1024 && smem > set) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    set = smem;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int fit = sms * (per_sm < kMaxBlocksPerSm ? per_sm : kMaxBlocksPerSm);
  *static_cast<int*>(most) = fit;
  if (fit >= blocks) {
    Plan p{};
    for (int i = 0; i < kLayoutLen; ++i) p.lay.v[i] = v[i];
    p.blocks = blocks;
    p.smem = smem;
    plans[std::make_tuple(dev, n, k, class_of(m), i8 != 0)] = p;
  }
  return static_cast<int>(cudaSuccess);
}

// x: bf16 [m, k]; q: int8 [n, k]; d: f32 [n, k/32]; y: f32 [m, n].
// 1 <= m <= 16 (above, q8_gemm.cu's q8_gemm), k % 32 == 0; all pointers
// 16-byte aligned (checked by the wrapper); a plan registered for (n, k,
// m's class) on this device.
extern "C" int q8_matmul(const void* x, const void* q, const void* d, void* y,
                         int m, int n, int k, void* stream) {
  if (m < 1 || m > 16 || n < 1 || k < 32 || k % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_matvec(x, q, d, y, m, n, k, false, true,
                                        static_cast<cudaStream_t>(stream)));
}

// x: f32 [m, k]; wq: int8 [n, k]; wd: f32 [n, k/32]; y: f32 [m, n].
// 1 <= m <= 16, k % 32 == 0, 16-byte aligned pointers (checked by the
// wrapper), a plan registered as for q8_matmul. Returns the launch's
// cudaError_t.
extern "C" int q8dot_matmul(const void* x, const void* wq, const void* wd,
                            void* y, int m, int n, int k, void* stream) {
  if (m < 1 || m > 16 || n < 1 || k < 32 || k % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_matvec(x, wq, wd, y, m, n, k, true, false,
                                        static_cast<cudaStream_t>(stream)));
}

// q8dot_matmul on bf16 rows x [m, k] (the decoder's): the same products,
// without a cast of the rows to f32 before the launch.
extern "C" int q8dot_matmul_bf16(const void* x, const void* wq,
                                 const void* wd, void* y, int m, int n, int k,
                                 void* stream) {
  if (m < 1 || m > 16 || n < 1 || k < 32 || k % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_matvec(x, wq, wd, y, m, n, k, true, true,
                                        static_cast<cudaStream_t>(stream)));
}
