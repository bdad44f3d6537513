// K4 — fused per-layer q8_0 chain for Hopper (sm_90a), one cooperative
// launch on the streaming weight engine (q8_stream.cuh).
//
//   h1  = xm . o^T + resid                                   (f32)
//   nh  = bf16(rmsnorm(h1) * post_w)
//   act = bf16(silu(nh . gate^T) * (nh . up^T))              (gate_up packed)
//   out = act . down^T + h1                                  (f32, output)
//   qkv = bf16(rmsnorm(out) * next_w) . next_qkv^T           (f32, optional)
//
// Replaces the Pallas kernels fun_asr_gguf_tpu/ops/quant_matmul.py
// q8_mlp_qkv_fused (:832, K4a; grid=(1,) body _q8_mlp_qkv_fused_body :770)
// and q8_mlp_fused (:649, K4b: the same chain without the next-layer
// stage), both through the staged form _q8_mega_staged_call (:1183), and —
// with the final norm in next_w and the 152576-row q8_0 lm_head in the qkv
// slot, so that qkv is the logits — q8_layer_head_fused (:953, K4c).
// Numerics follow the JAX reference path (_q8_mlp_fused_ref :623,
// _q8_mlp_qkv_fused_ref :814): every q*d is formed in f32 and rounded to
// bf16 once (the Pallas bodies' bf16 rounding of d is not copied);
// activations entering a product are bf16; products and sums in f32; both
// RMSNorms (mean over the whole row) and both residual adds in f32.
// Weights stay in natural GGUF order: the TPU's perm space does not exist
// here.
//
// What bounds it: bytes. A K4a call at Qwen3-0.6B width reads 15.73 MB of
// int8 plus 1.97 MB of f32 scales (o 1024x2048, gate_up 6144x1024, down
// 1024x3072, next qkv 4096x1024): 17.69 MB, a 5.3 us floor at the H100's
// 3.35 TB/s, at m = 1 (decode) and m = 9 (a verify round) alike. As K4c
// the last stage streams the head (152576x1024 int8 + f32 scales, 175.77
// MB): 189.3 MB, a 0.0565 ms floor. Row offsets are size_t, so the head's
// rows and the [m, 152576] logits index without overflow.
//
// Design. Every stage needs the whole previous row (an RMSNorm needs all
// 1024 outputs of o, down all gated values), so the chain is one
// cooperative launch with a grid barrier between stages:
//   o + residual | norm + gate_up + gate | down + residual | norm + qkv/head
// What the design does about what held the warp-per-row form back:
// - The weights were read by the warps that computed, so each stage waited
//   on DRAM latency and nothing of the next stage was in flight across a
//   barrier (the TPU kernel's sequential grid prefetches the next chunk
//   across its stages). Here the wrapper splits each matrix into
//   contiguous ranges of whole rows per block (ops/quant_matmul.py
//   q8_layer_fused_split: gate row j with up row j; the table and the
//   shared-memory layout come from the card in `plan`), and thread 0 of
//   each block requests its slabs by TMA bulk copies (q8s::bulk_load), one
//   mbarrier each, in the launch's first instructions: o, gate_up and
//   down always; the qkv slab too where shared memory has room, else into
//   gate_up's slot just after gate_up's barrier; the head's first ring
//   tiles likewise. A stage waits only on its own slab.
//   Where a matrix's width is not a multiple of 128, the scales of a row
//   range are not whole 16-byte words: the block copies them with plain
//   loads beside the bulk copy of the int8 rows.
// - At m = 9 each weight row re-read every activation row through L2. The
//   activation rows now sit in shared memory (written once per block per
//   stage; for m > 1 as bf16 rows, in chunks of columns where m rows of
//   the widest matrix do not fit), and:
//   * m = 1 (two blocks an SM): K5's unit dot (q8s::slab_dot) on an f32
//     row: units of (row, 512 columns), so every warp has work on o's and
//     down's 3-4 rows a block.
//   * m = 2..16 (one block an SM): mma.sync m16n8k16, bf16 in, f32
//     accumulate. A is the activation rows (padded to 16 with zeros), B
//     eight weight rows dequantized in registers. The k order inside a
//     16-column step is free as long as A and B agree: lane (g, t) takes
//     columns 16t..16t+15 of a 64-column span of weight row g (16 int8
//     bytes, one q8_0 scale) and the same columns of activation rows g and
//     g + 8 (two 16-byte loads each; rows padded by 16 bytes, so the loads
//     are conflict-free), four steps of 4 columns. So each weight is
//     dequantized once per block for all m rows. A work item is (a group
//     of four 8-row tiles, a slice of the spans): each activation fragment
//     is loaded once for 32 weight rows, and the items are enough for
//     every warp; the slices' partial tiles meet in shared memory and are
//     added in slice order.
//   K4c's head streams through a ring of 32-row tiles from gate_up's slot
//   (tiles past that slot go out at the start, the rest after gate_up's
//   barrier; each slot is requested again as soon as its tile is done).
// - Per-call fixed cost: the requests go out before anything else, so the
//   first slab is on its way while the launch settles. What remains of
//   the first stage is mostly the launch's ramp and the first bytes'
//   latency: requesting only o's slab first, or prefetching the next
//   layer's o into L2 during the last stage, did not shorten it on the
//   H100 (PERF.md §6).
// Every row's sum is taken in a fixed order whatever the blocks' timing,
// so repeated calls are equal bit for bit. The row norms are computed by
// every block after the barrier from the f32 rows written in the launch
// (read via L2, ld.global.cg), instead of another barrier.
//
// The stage timer (a non-null `stamps`, a measurement, never on the decode
// path): block 0's thread 0 writes %globaltimer and clock64 at the start,
// clock64 after each grid barrier and at the end, %globaltimer at the end.
//
// K7 — the int8-dot q8_0 layer chain: the same kernel under the other dot
// contract (template argument kI8), the same split, slabs and requests
// (its weights are K4's bytes relabelled):
//
//   h1  = q8(attn) . o^T + resid                                (f32)
//   act = silu(q8(rms(h1) * post_w) . gate^T) * (... . up^T)    (f32)
//   out = q8(act) . down^T + h1                                 (f32, output)
//   qkv = q8(rms(out) * next_w) . next_qkv^T                    (f32, optional)
//
// q8(.) is the q8_0 quantization of f32 rows per 32-block, and every
// product is llama.cpp's q8_0 x q8_0 block dot (q8_slab.cuh): an exact int32
// partial per block, then * d_w * d_x in f32, summed in f32. Replaces the
// Pallas kernels fun_asr_gguf_tpu/ops/quant_matmul.py q8i_layer_fused
// (:1586; pallas_call :1650 with the next layer's qkv, :1667 without; body
// _q8i_layer_body :1516) with the numerics of _q8i_layer_ref (:1550): every
// intermediate f32, only the quantizations round. Stage 1 takes the merged
// attention rows (bf16, as K2 returns them) and quantizes them itself, the
// caller's quantize_act_q8 folded in, or takes them quantized (the JAX
// signature's entry): the same IEEE arithmetic, so both give the same bytes
// and the same outputs bit for bit.
// What bounds it: bytes, K4a's 17.69 MB a call (12.98 without the qkv), a
// 5.3 us floor at 3.35 TB/s, at m = 1 and m = 9 alike.
// What the design does about the warp-per-row form it replaces (one warp
// an output row, its weight row read through __ldg, so each stage waited
// on DRAM latency and nothing was in flight across the barriers; dp4a once
// per activation row, 16 rows of registers at m = 9; the attention rows
// quantized by ~16 small kernels on the host side of every layer):
// - K4's stream: each block's slabs requested in the first instructions; a
//   stage waits only on its own slab's mbarrier.
// - The activation rows sit in shared memory as q8_0, int8 rows and f32
//   block scales (m k + m k / 8 bytes, rows padded by 32 bytes). Every
//   block quantizes the attention rows and the normed rows itself after a
//   barrier, from the rows in device memory (read via L2; four lanes a
//   block, amax by shuffles: quant_rows). At m > 1 that work, not the
//   stream, set the stages' times, so the gated rows are quantized once,
//   by the block that produces them (the split gives it whole 32-pair
//   blocks), and the down stage copies the q8_0 rows.
// - m = 1: K5's units of 512 columns, dp4a on the int8 slab and row
//   (q8s::slab_dot_i8): no dequant, four MACs an instruction, one f32
//   multiply pair a block.
// - m = 2..16: mma.sync m16n8k32 s8 (mma_slab_i8): one mma is one q8_0
//   block, its int32 fragment the block's exact partial for (activation
//   row, weight row), converted exactly (q8s::i2f_exact) and scaled into f32
//   accumulators; K4's items (four 8-row tiles x a slice of the spans).
// The RMSNorm's 1/sqrt is IEEE, as K4's; the plain version's torch.rsqrt
// may differ by an ulp and so flip an isolated int8 value at a .5 boundary.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "q8_slab.cuh"
#include "q8_stream.cuh"

namespace cg = cooperative_groups;

namespace {

using q8::kThreads;
using q8::kWarps;
using namespace q8s;

// the split table's rows (row, or gate/up pair, starts per block)
enum Mat { kO = 0, kGateUp, kDown, kQkv, kMats };
// the plan's leading ints (ops/quant_matmul.py K4_LAYOUT, in this order):
// byte offsets of the activation rows, the unit sums, the mbarriers and the
// slots; gate_up's slot size; the activation chunk's columns
// and bytes a row; each stage's slices (mma) of spans; the head's tile
// rows (0: no head), ring depth and one unit-sum buffer's floats
enum Lay {
  kX = 0, kRed, kBars, kSlotO, kSlotGateUp, kSlotDown, kSlotQkv,
  kSizeGateUp, kXcols, kXstride, kSO, kSGateUp, kSDown, kSQkv, kHeadRows,
  kHeadTiles, kRedFloats, kLayoutLen
};
enum Mode { kUnit = 0, kMmaLo, kMmaHi };   // m = 1, 2..8, 9..16

constexpr int kMaxHeadTiles = 16;
constexpr int kMaxBlocksPerSm = 2;

struct Args {
  const __nv_bfloat16* xm;      // [m, qd]
  const __nv_bfloat16* resid;   // [m, h]
  const __nv_bfloat16* post_w;  // [h]
  const __nv_bfloat16* next_w;  // [h]        (null without the qkv stage)
  const int8_t* oq;             // [h, qd]
  const float* od;              // [h, qd/32]
  const int8_t* gq;             // [2f, h]    gate rows, then up rows
  const float* gd;
  const int8_t* dq;             // [h, f]
  const float* dd;
  const int8_t* qq;             // [nq, h]    (null without the qkv stage)
  const float* qs;
  float* h1;                    // scratch [m, h]
  __nv_bfloat16* act;           // scratch [m, f]
  float* out;                   // [m, h]
  float* qkv;                   // [m, nq]
  long long* stamps;            // the stage timer [7], or null
  const int* plan;              // [kLayoutLen + 4 (grid + 1)]
  int m, qd, h, f, nq;
  float eps;
  // K7 (kI8): the attention rows in bf16 (xm) or already in q8_0 (aq
  // [m, qd] int8, as [m, qd/32] f32); the f32 residual; the gated rows:
  // f32 at m = 1, else q8_0 (one scratch: int8, then the scales)
  const int8_t* aq;
  const float* as;
  const float* resid32;         // [m, h]
  float* act32;                 // scratch [m, f]       (m = 1)
  int8_t* actq;                 // scratch [m, f]       (m > 1)
  float* acts;                  // scratch [m, f/32]    (m > 1)
};

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

// The mma form of a slab's dot products over columns [c0, c1) (a chunk of
// the activation rows X: bf16, `xstride` bytes a row, column c0 first).
// Work item it = (group it / S of kGroup 8-row tiles, slice it % S of the
// rows' 64-column spans): each activation fragment is loaded once for the
// group's tiles. The item writes (add: adds) its partial tiles, [rows][8]
// each, to red[(it kGroup + tile) kStride]. Lanes past the slab's rows
// read its last row; their columns of a tile are never read.
template <bool kHi>
__device__ void mma_slab(const unsigned char* slot, int R, int k, int S,
                         int c0, int c1, const unsigned char* X, int xstride,
                         int m, float* red, bool add) {
  constexpr int kStride = kHi ? 128 : 64;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = (R + 7) / 8;
  const int items = (tiles + kGroup - 1) / kGroup * S;
  const int ns = (k + kSpan - 1) / kSpan, nb = k >> 5;
  const int sp_lo = c0 / kSpan, sp_hi = (c1 + kSpan - 1) / kSpan;
  const float* d = reinterpret_cast<const float*>(
      slot + static_cast<size_t>(R) * k);
  const bool has0 = g < m, has1 = kHi && g + 8 < m;
  const unsigned char* x0 = X + g * xstride;
  const unsigned char* x1 = X + (g + 8) * xstride;
  for (int it = warp; it < items; it += kWarps) {
    const int grp = it / S, sl = it - grp * S;
    const int nt = min(kGroup, tiles - grp * kGroup);   // warp-uniform
    const unsigned char* wq[kGroup];
    const float* wd[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int j = min((grp * kGroup + i) * 8 + g, R - 1);
      wq[i] = slot + static_cast<size_t>(j) * k;
      wd[i] = d + j * nb;
    }
    const int a = max(sl * ns / S, sp_lo), b = min((sl + 1) * ns / S, sp_hi);
    float c[kGroup][4] = {};
    for (int sp = a; sp < b; ++sp) {
      const int col = sp * kSpan + 16 * t;
      const bool in = col < c1;   // k % 32 == 0: 16 columns all in or out
      uint4 xa = make_uint4(0u, 0u, 0u, 0u);
      uint4 xb = xa, ya = xa, yb = xa;
      const int xo = (col - c0) * 2;
      if (in && has0) {
        xa = *reinterpret_cast<const uint4*>(x0 + xo);
        xb = *reinterpret_cast<const uint4*>(x0 + xo + 16);
      }
      if (in && has1) {
        ya = *reinterpret_cast<const uint4*>(x1 + xo);
        yb = *reinterpret_cast<const uint4*>(x1 + xo + 16);
      }
      const unsigned A0[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      const unsigned A1[8] = {ya.x, ya.y, ya.z, ya.w, yb.x, yb.y, yb.z, yb.w};
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        if (i >= nt) break;
        uint4 qv = make_uint4(0u, 0u, 0u, 0u);
        float s = 0.f;
        if (in) {
          qv = *reinterpret_cast<const uint4*>(wq[i] + col);
          s = wd[i][col >> 5];
        }
        const unsigned w[4] = {qv.x ^ 0x80808080u, qv.y ^ 0x80808080u,
                               qv.z ^ 0x80808080u, qv.w ^ 0x80808080u};
#pragma unroll
        for (int st = 0; st < 4; ++st)   // columns 16t + 4st .. + 3
          mma16816(c[i], A0[2 * st], A1[2 * st], A0[2 * st + 1],
                   A1[2 * st + 1], deq2(w[st], 0x7540, 0x7541, s),
                   deq2(w[st], 0x7542, 0x7543, s));
      }
    }
    // c[i][0], c[i][1]: activation row g, weight rows 2t, 2t + 1 of tile
    // i; c[i][2], c[i][3]: activation row g + 8
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      if (i >= nt) break;
      float* r = red + (it * kGroup + i) * kStride + g * 8 + 2 * t;
      if (add) {
        r[0] += c[i][0];
        r[1] += c[i][1];
        if (kHi) {
          r[64] += c[i][2];
          r[65] += c[i][3];
        }
      } else {
        r[0] = c[i][0];
        r[1] = c[i][1];
        if (kHi) {
          r[64] = c[i][2];
          r[65] = c[i][3];
        }
      }
    }
  }
}

// X rows = bf16((x * 1/sqrt(mean(x^2) + eps)) * w) of the f32 rows x [m, h]
// written in this launch (read via L2), one warp a row
__device__ void rms_rows(const float* x, const __nv_bfloat16* w, int m,
                         int h, float eps, unsigned char* X, int xstride) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < m; r += kWarps) {
    const float* xr = x + static_cast<size_t>(r) * h;
    float ss = 0.f;
    for (int c = lane * 4; c < h; c += 128) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(xr + c));
      ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
    }
    const float inv = 1.f / sqrtf(q8::warp_sum(ss) / static_cast<float>(h)
                                  + eps);
    for (int c = lane * 4; c < h; c += 128) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(xr + c));
      const uint2 wr = __ldg(reinterpret_cast<const uint2*>(w + c));
      const __nv_bfloat16* wb = reinterpret_cast<const __nv_bfloat16*>(&wr);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(
          (v.x * inv) * __bfloat162float(wb[0]),
          (v.y * inv) * __bfloat162float(wb[1]));
      const __nv_bfloat162 hi = __floats2bfloat162_rn(
          (v.z * inv) * __bfloat162float(wb[2]),
          (v.w * inv) * __bfloat162float(wb[3]));
      uint2 o;
      o.x = *reinterpret_cast<const unsigned*>(&lo);
      o.y = *reinterpret_cast<const unsigned*>(&hi);
      *reinterpret_cast<uint2*>(X + r * xstride + c * 2) = o;
    }
  }
}

// ---------------------------------------------------------------------------
// K7: the activation rows in q8_0 (quant_rows: q8_slab.cuh), and the
// s8 x s8 mma form of a slab
// ---------------------------------------------------------------------------

// Rows [0, m), columns [c0, c1), of q8_0 rows in device memory (aq int8
// [m, k], as f32 [m, k / 32]; quantized before the launch or in it, read
// via L2) into X and xs as quant_rows lays them out in shared memory.
__device__ void copy_q8_rows(const int8_t* aq, const float* as, int m, int k,
                             int c0, int c1, unsigned char* X, int xstride,
                             float* xs, int bs) {
  const int w = (c1 - c0) >> 4, nb = (c1 - c0) >> 5;
  for (int i = threadIdx.x; i < m * w; i += kThreads) {
    const int r = i / w, c = c0 + 16 * (i - r * w);
    *reinterpret_cast<uint4*>(X + r * xstride + (c - c0)) = __ldcg(
        reinterpret_cast<const uint4*>(aq + static_cast<size_t>(r) * k + c));
  }
  for (int i = threadIdx.x; i < m * nb; i += kThreads) {
    const int r = i / nb, b = i - r * nb;
    xs[b * bs + r] = __ldcg(as + static_cast<size_t>(r) * (k >> 5) +
                            (c0 >> 5) + b);
  }
}

// rs[r] = 1 / sqrt(mean(x[r]^2) + eps) of the f32 rows x [m, h] written in
// this launch (read via L2), one warp a row (rms_rows' sum)
__device__ void row_norms(const float* x, int m, int h, float eps,
                          float* rs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < m; r += kWarps) {
    const float* xr = x + static_cast<size_t>(r) * h;
    float ss = 0.f;
#pragma unroll 8
    for (int c = lane * 4; c < h; c += 128) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(xr + c));
      ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
    }
    ss = q8::warp_sum(ss);
    if (lane == 0) rs[r] = 1.f / sqrtf(ss / static_cast<float>(h) + eps);
  }
}

// four bf16 as f32
__device__ __forceinline__ float4 bf16x4(uint2 v) {
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// The int8-dot mma form of a slab's dot products over columns [c0, c1) of
// the q8_0 activation rows (X: int8 rows `xstride` bytes apart, column c0
// first; xs: their scales, [block of the chunk][kHi ? 16 : 8]). Work item
// it = (group it / S of kGroup 8-row tiles, slice it % S of the rows'
// 64-column spans, two q8_0 blocks each), as mma_slab; the partial tiles go to red as
// there. One m16n8k32 mma is one block: its int32 fragment is the block's
// exact partial for (activation row, weight row), converted exactly and
// scaled by d_w d_x into f32 accumulators in block order. The k order
// inside a block is free as long as A and B agree: lane (g, t) loads the
// 16 bytes at 16 t of a span of weight row g (one 16-byte load a tile),
// and lanes t and t ^ 2 swap halves, so that for each block of the span
// lane t holds the block's bytes off(t) .. off(t) + 7, off(t) = 8 (2 (t &
// 1) + (t >> 1)); activation rows g and g + 8 give the same bytes (one
// 8-byte load each; rows padded by 32 bytes, so the loads are conflict
// free). A span past k holds one block. Lanes past the slab's rows read
// its last row; their columns of a tile are never read.
template <bool kHi>
__device__ void mma_slab_i8(const unsigned char* slot, int R, int k, int S,
                            int c0, int c1, const unsigned char* X,
                            int xstride, const float* xs, int m, float* red,
                            bool add) {
  constexpr int kStride = kHi ? 128 : 64;
  constexpr int kBs = kHi ? 16 : 8;   // scales a block
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool lo = t < 2;
  const int tiles = (R + 7) / 8;
  const int items = (tiles + kGroup - 1) / kGroup * S;
  const int ns = (k + kSpan - 1) / kSpan, nb = k >> 5;
  const int sp_lo = c0 / kSpan, sp_hi = (c1 + kSpan - 1) / kSpan;
  const float* d = reinterpret_cast<const float*>(
      slot + static_cast<size_t>(R) * k);
  const bool has0 = g < m, has1 = kHi && g + 8 < m;
  const int off = 8 * (2 * (t & 1) + (t >> 1));
  const unsigned char* x0 = X + g * xstride + off;
  const unsigned char* x1 = X + (g + 8) * xstride + off;
  for (int it = warp; it < items; it += kWarps) {
    const int grp = it / S, sl = it - grp * S;
    const int nt = min(kGroup, tiles - grp * kGroup);   // warp-uniform
    // offsets of weight row g's bytes and rows 2t, 2t + 1's scales
    int wq[kGroup], w0d[kGroup], w1d[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int base = (grp * kGroup + i) * 8;
      wq[i] = min(base + g, R - 1) * k;
      w0d[i] = min(base + 2 * t, R - 1) * nb;
      w1d[i] = min(base + 2 * t + 1, R - 1) * nb;
    }
    const int a = max(sl * ns / S, sp_lo), b = min((sl + 1) * ns / S, sp_hi);
    float c[kGroup][4] = {};
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
      if (has1) {
        ya = *reinterpret_cast<const uint2*>(x1 + xc);
        ta = xsb[g + 8];
        if (two) {
          yb = *reinterpret_cast<const uint2*>(x1 + xc + 32);
          tb = xsb[kBs + 8 + g];
        }
      }
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        if (i >= nt) break;
        uint4 q = make_uint4(0u, 0u, 0u, 0u);
        if (lo || two) q = *reinterpret_cast<const uint4*>(slot + wq[i] + col
                                                           + 16 * t);
        const unsigned s0 = lo ? q.z : q.x, s1 = lo ? q.w : q.y;
        const unsigned r0 = __shfl_xor_sync(0xffffffffu, s0, 2);
        const unsigned r1 = __shfl_xor_sync(0xffffffffu, s1, 2);
        // z[0], z[1]: activation row g, weight rows 2t, 2t + 1 of tile i;
        // z[2], z[3]: activation row g + 8
        int z[4];
        mma_s8(z, xa.x, ya.x, xa.y, ya.y, lo ? q.x : r0, lo ? q.y : r1);
        float w0 = d[w0d[i] + blk], w1 = d[w1d[i] + blk];
        c[i][0] = fmaf(i2f_exact(z[0]) * w0, sa, c[i][0]);
        c[i][1] = fmaf(i2f_exact(z[1]) * w1, sa, c[i][1]);
        if (kHi) {
          c[i][2] = fmaf(i2f_exact(z[2]) * w0, ta, c[i][2]);
          c[i][3] = fmaf(i2f_exact(z[3]) * w1, ta, c[i][3]);
        }
        if (two) {   // warp-uniform
          mma_s8(z, xb.x, yb.x, xb.y, yb.y, lo ? r0 : q.z, lo ? r1 : q.w);
          w0 = d[w0d[i] + blk + 1];
          w1 = d[w1d[i] + blk + 1];
          c[i][0] = fmaf(i2f_exact(z[0]) * w0, sb, c[i][0]);
          c[i][1] = fmaf(i2f_exact(z[1]) * w1, sb, c[i][1]);
          if (kHi) {
            c[i][2] = fmaf(i2f_exact(z[2]) * w0, tb, c[i][2]);
            c[i][3] = fmaf(i2f_exact(z[3]) * w1, tb, c[i][3]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      if (i >= nt) break;
      float* r = red + (it * kGroup + i) * kStride + g * 8 + 2 * t;
      if (add) {
        r[0] += c[i][0];
        r[1] += c[i][1];
        if (kHi) {
          r[64] += c[i][2];
          r[65] += c[i][3];
        }
      } else {
        r[0] = c[i][0];
        r[1] = c[i][1];
        if (kHi) {
          r[64] = c[i][2];
          r[65] = c[i][3];
        }
      }
    }
  }
}

template <int kMode, bool kI8>
__global__ void __launch_bounds__(kThreads, kMode == kUnit ? 2 : 1)
q8_layer_fused_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kMma = kMode != kUnit;
  const int tid = threadIdx.x;
  const int m = a.m, h = a.h, f = a.f;
  int lay[kLayoutLen];
#pragma unroll
  for (int i = 0; i < kLayoutLen; ++i) lay[i] = __ldg(a.plan + i);
  int lo[kMats], n[kMats];
#pragma unroll
  for (int i = 0; i < kMats; ++i) {
    const int* row = a.plan + kLayoutLen + i * (gridDim.x + 1) + blockIdx.x;
    lo[i] = __ldg(row);
    n[i] = __ldg(row + 1) - lo[i];
  }
  const bool timed = a.stamps != nullptr && blockIdx.x == 0 && tid == 0;
  if (timed) {
    a.stamps[0] = global_ns();
    a.stamps[1] = clock64();
  }
  unsigned char* X = smem + lay[kX];
  float* xs = reinterpret_cast<float*>(X);   // K4 kUnit: one f32 row
  float* red = reinterpret_cast<float*>(smem + lay[kRed]);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay[kBars]);
  uint64_t* hbar = bars + kMats;             // the head ring's tiles
  float* part = reinterpret_cast<float*>(hbar + kMaxHeadTiles);
  unsigned char* slot[kMats] = {smem + lay[kSlotO], smem + lay[kSlotGateUp],
                                smem + lay[kSlotDown], smem + lay[kSlotQkv]};
  const int xcols = lay[kXcols], xstride = lay[kXstride];
  const int hr = lay[kHeadRows], nt = lay[kHeadTiles];
  const bool with_q = a.qq != nullptr;
  const unsigned tb = slab_bytes(hr, h);
  const int tiles = hr > 0 ? (n[kQkv] + hr - 1) / hr : 0;
  // K7: the q8_0 rows' scales (after the rows: block-major, 8 or 16 rows
  // a block for the mma form; after the one row at m = 1), and the rows'
  // norms in the head ring's mbarrier words (K7 has no head)
  float* qs = reinterpret_cast<float*>(X + (kMma ? m * xstride : xcols));
  constexpr int kBs = kMode == kMmaHi ? 16 : kMma ? 8 : 1;
  float* rs = reinterpret_cast<float*>(hbar);

  if (tid == 0) {
    for (int i = 0; i < kMats + nt; ++i) bar_init(bars + i);
    bar_init_fence();
  }
  __syncthreads();
  fetch(slot[kO], bars + kO, a.oq, a.od, a.qd, lo[kO], n[kO], 0);
  fetch(slot[kGateUp], bars + kGateUp, a.gq, a.gd, h, lo[kGateUp],
        n[kGateUp], f);
  fetch(slot[kDown], bars + kDown, a.dq, a.dd, f, lo[kDown], n[kDown], 0);
  // The qkv slab (or each of the head's first tiles) goes out at the start
  // unless its bytes overlap gate_up's slot: then after gate_up's barrier
  // (stage 2).
  auto when = [&](size_t off, size_t bytes) {
    const size_t s = lay[kSlotGateUp];
    return off < s + lay[kSizeGateUp] && s < off + bytes ? 2 : 0;
  };
  auto late = [&](int stage) {
    if (!with_q) return;
    if (hr == 0) {
      if (when(lay[kSlotQkv], slab_bytes(n[kQkv], h)) == stage)
        fetch(slot[kQkv], bars + kQkv, a.qq, a.qs, h, lo[kQkv], n[kQkv], 0);
      return;
    }
    for (int s = 0; s < nt && s < tiles; ++s)
      if (when(lay[kSlotQkv] + static_cast<size_t>(s) * tb, tb) == stage)
        fetch(slot[kQkv] + static_cast<size_t>(s) * tb, hbar + s, a.qq, a.qs,
              h, static_cast<size_t>(lo[kQkv]) + s * hr,
              min(hr, n[kQkv] - s * hr), 0);
  };
  late(0);

  // the slab's dot products into rb, and row j's against activation row r
  auto dot = [&](const unsigned char* s, int R, int k, int S, int c0, int c1,
                 float* rb, bool add) {
    if constexpr (kI8 && kMode == kUnit)
      slab_dot_i8(s, R, k, reinterpret_cast<const int8_t*>(X), qs, rb);
    else if constexpr (kI8)
      mma_slab_i8<kMode == kMmaHi>(s, R, k, S, c0, c1, X, xstride, qs, m, rb,
                                   add);
    else if constexpr (kMode == kUnit)
      slab_dot(s, R, k, xs, rb);
    else
      mma_slab<kMode == kMmaHi>(s, R, k, S, c0, c1, X, xstride, m, rb, add);
  };
  auto val = [&](const float* rb, int j, int r, int k, int S) {
    if constexpr (kMode == kUnit) {
      return row_sum(rb, j, units_per_row(k));
    } else {
      constexpr int kStride = kMode == kMmaHi ? 128 : 64;
      const float* p = rb + ((j >> 5) * S * kGroup + ((j >> 3) & 3)) * kStride
                       + r * 8 + (j & 7);
      float v = 0.f;
      for (int sl = 0; sl < S; ++sl) v += p[sl * kGroup * kStride];
      return v;
    }
  };
  // a GEMV stage over rows src [m, k] in column chunks of the activation
  // buffer (one chunk unless m rows of k do not fit): K4's bf16 rows, or
  // K7's fill(c0, c1), which writes a chunk's q8_0 rows
  auto chunked = [&](auto src, int mat, int k, int S) {
    for (int c0 = 0; c0 < k; c0 += xcols) {
      const int c1 = min(k, c0 + xcols);
      if (c0 > 0) __syncthreads();
      if constexpr (kI8) src(c0, c1);
      else if constexpr (kMma) load_rows(src, m, k, c0, c1, X, xstride);
      else load_x(src, k, xs);
      __syncthreads();
      if (c0 == 0) bar_wait(bars + mat, 0);
      dot(slot[mat], n[mat], k, S, c0, c1, red, c0 > 0);
    }
    __syncthreads();
  };
  // K7: the q8_0 form of the f32 values value(r, c)
  auto q8_rows = [&](auto value) {
    return [&, value](int c0, int c1) {
      quant_rows(value, m, c0, c1, X, xstride, qs, kBs, 1);
    };
  };
  // the rows entering the next product after an RMSNorm of x with w
  auto norm = [&](const float* x, const __nv_bfloat16* w) {
    if constexpr (kI8) {
      row_norms(x, m, h, a.eps, rs);
      __syncthreads();
      q8_rows([&](int r, int c) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(
            x + static_cast<size_t>(r) * h + c));
        const float4 g = bf16x4(__ldg(reinterpret_cast<const uint2*>(w + c)));
        const float s = rs[r];
        return make_float4(__fmul_rn(__fmul_rn(v.x, s), g.x),
                           __fmul_rn(__fmul_rn(v.y, s), g.y),
                           __fmul_rn(__fmul_rn(v.z, s), g.z),
                           __fmul_rn(__fmul_rn(v.w, s), g.w));
      })(0, h);
      __syncthreads();
    } else if constexpr (kMma) {
      rms_rows(x, w, m, h, a.eps, X, xstride);
      __syncthreads();
    } else {
      rms_to_xs(x, w, h, a.eps, xs, part);
    }
  };
  cg::grid_group grid = cg::this_grid();

  // stage 1: h1 = xm . o^T + resid
  if constexpr (kI8) {
    const int qd = a.qd;
    chunked([&](int c0, int c1) {
      if (a.aq != nullptr) {
        copy_q8_rows(a.aq, a.as, m, qd, c0, c1, X, xstride, qs, kBs);
      } else {
        q8_rows([&](int r, int c) {
          return bf16x4(__ldg(reinterpret_cast<const uint2*>(
              a.xm + static_cast<size_t>(r) * qd + c)));
        })(c0, c1);
      }
    }, kO, qd, lay[kSO]);
  } else {
    chunked(a.xm, kO, a.qd, lay[kSO]);
  }
  for (int i = tid; i < m * n[kO]; i += kThreads) {
    const int r = i / n[kO], j = i - r * n[kO];
    const size_t at = static_cast<size_t>(r) * h + lo[kO] + j;
    float res;
    if constexpr (kI8) res = __ldg(a.resid32 + at);
    else res = __bfloat162float(a.resid[at]);
    a.h1[at] = val(red, j, r, a.qd, lay[kSO]) + res;
  }
  grid.sync();
  if (timed) a.stamps[2] = clock64();

  // stage 2: act = silu(nh . gate^T) * (nh . up^T), nh from h1 (K4: bf16)
  norm(a.h1, a.post_w);
  bar_wait(bars + kGateUp, 0);
  dot(slot[kGateUp], 2 * n[kGateUp], h, lay[kSGateUp], 0, h, red, false);
  __syncthreads();
  // K7 at m > 1: the gated rows of the block's pairs (whole 32-blocks: the
  // split aligns them) into the activation buffer as f32, then quantized
  // once, here, into q8_0 rows in device memory, which stage 3 copies
  // (rebuilding m rows from f32 in every block cost more than the stream);
  // at m = 1 the f32 row goes to device memory and every block quantizes it
  float* gated = reinterpret_cast<float*>(X);
  for (int i = tid; i < m * n[kGateUp]; i += kThreads) {
    const int r = i / n[kGateUp], p = i - r * n[kGateUp];
    const float g = val(red, p, r, h, lay[kSGateUp]);
    const float u = val(red, n[kGateUp] + p, r, h, lay[kSGateUp]);
    const size_t at = static_cast<size_t>(r) * f + lo[kGateUp] + p;
    if constexpr (kI8 && kMma) gated[i] = g / (1.f + expf(-g)) * u;
    else if constexpr (kI8) a.act32[at] = g / (1.f + expf(-g)) * u;
    else a.act[at] = __float2bfloat16(g / (1.f + expf(-g)) * u);
  }
  if constexpr (kI8 && kMma) {
    const int np = n[kGateUp], c0 = lo[kGateUp];
    __syncthreads();
    quant_rows([&](int r, int c) {
      return *reinterpret_cast<const float4*>(gated + r * np + (c - c0));
    }, m, c0, c0 + np, reinterpret_cast<unsigned char*>(a.actq) + c0, f,
       a.acts + (c0 >> 5), 1, f >> 5);
  }
  grid.sync();
  if (timed) a.stamps[3] = clock64();
  late(2);

  // stage 3: out = act . down^T + h1
  if constexpr (kI8 && kMma) {
    chunked([&](int c0, int c1) {
      copy_q8_rows(a.actq, a.acts, m, f, c0, c1, X, xstride, qs, kBs);
    }, kDown, f, lay[kSDown]);
  } else if constexpr (kI8) {
    const float* act = a.act32;
    chunked(q8_rows([&, act](int r, int c) {
      return __ldcg(reinterpret_cast<const float4*>(
          act + static_cast<size_t>(r) * f + c));
    }), kDown, f, lay[kSDown]);
  } else {
    chunked(a.act, kDown, f, lay[kSDown]);
  }
  for (int i = tid; i < m * n[kDown]; i += kThreads) {
    const int r = i / n[kDown], j = i - r * n[kDown];
    const size_t at = static_cast<size_t>(r) * h + lo[kDown] + j;
    a.out[at] = val(red, j, r, f, lay[kSDown]) + __ldcg(a.h1 + at);
  }
  if (with_q) {   // uniform over the grid: no barrier skipped
    grid.sync();
    if (timed) a.stamps[4] = clock64();

    // stage 4: the next layer's input norm of out, then its qkv (or the
    // final norm and the head, in tiles through the ring)
    norm(a.out, a.next_w);
    const int S = lay[kSQkv];
    if (hr == 0) {
      bar_wait(bars + kQkv, 0);
      dot(slot[kQkv], n[kQkv], h, S, 0, h, red, false);
      __syncthreads();
      for (int i = tid; i < m * n[kQkv]; i += kThreads) {
        const int r = i / n[kQkv], j = i - r * n[kQkv];
        a.qkv[static_cast<size_t>(r) * a.nq + lo[kQkv] + j] =
            val(red, j, r, h, S);
      }
    } else if constexpr (!kI8) {
      // the unit sums alternate between two buffers, so one __syncthreads
      // a tile both publishes its sums and frees its slot
      for (int t = 0; t < tiles; ++t) {
        const int s = t % nt, r0 = t * hr, rows = min(hr, n[kQkv] - r0);
        float* rb = red + (t & 1) * lay[kRedFloats];
        unsigned char* ring = slot[kQkv] + static_cast<size_t>(s) * tb;
        bar_wait(hbar + s, (t / nt) & 1);
        dot(ring, rows, h, S, 0, h, rb, false);
        __syncthreads();
        const int next = t + nt;
        if (next < tiles)
          fetch(ring, hbar + s, a.qq, a.qs, h,
                static_cast<size_t>(lo[kQkv]) + next * hr,
                min(hr, n[kQkv] - next * hr), 0);
        for (int i = tid; i < m * rows; i += kThreads) {
          const int r = i / rows, j = i - r * rows;
          a.qkv[static_cast<size_t>(r) * a.nq + lo[kQkv] + r0 + j] =
              val(rb, j, r, h, S);
        }
      }
    }
    if (timed) a.stamps[5] = clock64();
  } else if (timed) {
    a.stamps[4] = clock64();
  }
  if (timed) a.stamps[6] = global_ns();
}

using Kernel = void (*)(Args);

// the kernel of mode `mode` (kUnit, kMmaLo, kMmaHi) under K4's contract or
// K7's (i8)
Kernel kernel_of(int mode, bool i8) {
  static const Kernel kernels[2][3] = {
      {q8_layer_fused_kernel<kUnit, false>,
       q8_layer_fused_kernel<kMmaLo, false>,
       q8_layer_fused_kernel<kMmaHi, false>},
      {q8_layer_fused_kernel<kUnit, true>,
       q8_layer_fused_kernel<kMmaLo, true>,
       q8_layer_fused_kernel<kMmaHi, true>}};
  return kernels[i8 ? 1 : 0][mode];
}

// Co-resident blocks of the kernel of mode `mode` and contract i8 with
// `smem` bytes of dynamic shared memory on device dev (at most two an SM),
// cached per (dev, kernel, smem): a decode loop at one shape queries once.
cudaError_t grid_blocks(int dev, int mode, bool i8, size_t smem,
                        int* blocks) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, size_t>, int> cache;
  static std::map<std::pair<int, int>, size_t> smem_attr;  // opt-in set
  std::lock_guard<std::mutex> lock(mu);
  const int id = mode + (i8 ? 3 : 0);
  const auto key = std::make_tuple(dev, id, smem);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *blocks = hit->second;
    return cudaSuccess;
  }
  const void* kernel = reinterpret_cast<const void*>(kernel_of(mode, i8));
  int sms = 0, coop = 0, per_sm = 0;
  cudaError_t e =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // the opt-in only grows, so a larger layout set earlier stays allowed
  size_t& set = smem_attr[{dev, id}];
  if (e == cudaSuccess && smem > 48 * 1024 && smem > set) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e == cudaSuccess) set = smem;
  }
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (e != cudaSuccess) return e;
  *blocks = sms * (per_sm < kMaxBlocksPerSm ? per_sm : kMaxBlocksPerSm);
  cache[key] = *blocks;
  return cudaSuccess;
}

int mode_of(int m) { return m == 1 ? kUnit : m <= 8 ? kMmaLo : kMmaHi; }

// One cooperative launch of `blocks` blocks, refused (never run partially)
// when the card cannot make them co-resident; the launch's cudaError_t.
int launch(Args& a, bool i8, int blocks, int smem, void* stream) {
  const int mode = mode_of(a.m);
  int dev = 0, most = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = grid_blocks(dev, mode, i8, smem, &most);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (blocks > most)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel_of(mode, i8)), dim3(blocks),
      dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The co-resident grid at row count m with `smem` bytes of dynamic shared
// memory (blocks, out through `blocks`, an int; at most two an SM).
int grid_of(int m, int smem, bool i8, void* blocks) {
  if (m < 1 || m > 16 || smem < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = grid_blocks(dev, mode_of(m), i8, static_cast<size_t>(smem),
                    static_cast<int*>(blocks));
  return static_cast<int>(e);
}

}  // namespace

// xm: bf16 [m, qd]; resid: bf16 [m, h]; post_w, next_w: bf16 [h];
// o: int8 [h, qd] + f32 [h, qd/32]; gate_up: [2f, h]; down: [h, f];
// next qkv (or the head): [nq, h] (qq == null: no qkv stage, next_w and
// qkv unused); scratch h1: f32 [m, h], act: bf16 [m, f]; out: f32 [m, h];
// qkv: f32 [m, nq]; stamps: int64 [7] (the stage timer) or null; plan:
// int32 [17 + 4 (blocks + 1)], the layout and split table of
// ops/quant_matmul.py q8_layer_fused_split for this m, blocks and smem.
// 1 <= m <= 16, qd, h, f % 32 == 0, 16-byte aligned pointers (checked by
// the wrapper). Returns the launch's cudaError_t: a grid the card cannot
// make co-resident is refused, never run partially.
extern "C" int q8_layer_fused(const void* xm, const void* resid,
                              const void* post_w, const void* next_w,
                              const void* oq, const void* od, const void* gq,
                              const void* gd, const void* dq, const void* dd,
                              const void* qq, const void* qs, void* h1,
                              void* act, void* out, void* qkv, void* stamps,
                              const void* plan, int m, int qd, int h, int f,
                              int nq, float eps, int blocks, int smem,
                              void* stream) {
  if (m < 1 || m > 16 || qd % 32 || h % 32 || f % 32 || blocks < 1
      || smem < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const __nv_bfloat16*>(xm),
         static_cast<const __nv_bfloat16*>(resid),
         static_cast<const __nv_bfloat16*>(post_w),
         static_cast<const __nv_bfloat16*>(next_w),
         static_cast<const int8_t*>(oq), static_cast<const float*>(od),
         static_cast<const int8_t*>(gq), static_cast<const float*>(gd),
         static_cast<const int8_t*>(dq), static_cast<const float*>(dd),
         static_cast<const int8_t*>(qq), static_cast<const float*>(qs),
         static_cast<float*>(h1), static_cast<__nv_bfloat16*>(act),
         static_cast<float*>(out), static_cast<float*>(qkv),
         static_cast<long long*>(stamps), static_cast<const int*>(plan),
         m, qd, h, f, nq, eps};
  return launch(a, false, blocks, smem, stream);
}

// K7: attn: the merged attention rows [m, qd] in bf16, or null with aq: int8 [m, qd] + as: f32 [m, qd/32] (the rows in
// q8_0); resid: f32 [m, h]; post_w, next_w: bf16 [h]; o, gate_up, down,
// next qkv (qq == null: no qkv stage) as K4's; scratch h1: f32 [m, h],
// act: the gated rows, f32 [m, f] at m = 1, else int8 [m, f] then their
// f32 scales [m, f/32]; out: f32 [m, h]; qkv: f32 [m, nq]; stamps, plan as
// K4's (the split of q8_layer_fused_split(..., q8i=True): gate_up in whole
// 32-pair blocks at m > 1). The same checks and return value as
// q8_layer_fused.
extern "C" int q8i_layer_fused(const void* attn, const void* aq,
                               const void* as, const void* resid,
                               const void* post_w, const void* next_w,
                               const void* oq, const void* od, const void* gq,
                               const void* gd, const void* dq, const void* dd,
                               const void* qq, const void* qs, void* h1,
                               void* act, void* out, void* qkv, void* stamps,
                               const void* plan, int m, int qd, int h, int f,
                               int nq, float eps, int blocks, int smem,
                               void* stream) {
  if (m < 1 || m > 16 || qd % 32 || h % 32 || f % 32 || blocks < 1
      || smem < 1 || (attn == nullptr) == (aq == nullptr)
      || (aq != nullptr) != (as != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.xm = static_cast<const __nv_bfloat16*>(attn);
  a.aq = static_cast<const int8_t*>(aq);
  a.as = static_cast<const float*>(as);
  a.resid32 = static_cast<const float*>(resid);
  a.post_w = static_cast<const __nv_bfloat16*>(post_w);
  a.next_w = static_cast<const __nv_bfloat16*>(next_w);
  a.oq = static_cast<const int8_t*>(oq);
  a.od = static_cast<const float*>(od);
  a.gq = static_cast<const int8_t*>(gq);
  a.gd = static_cast<const float*>(gd);
  a.dq = static_cast<const int8_t*>(dq);
  a.dd = static_cast<const float*>(dd);
  a.qq = static_cast<const int8_t*>(qq);
  a.qs = static_cast<const float*>(qs);
  a.h1 = static_cast<float*>(h1);
  a.act32 = static_cast<float*>(act);
  a.actq = static_cast<int8_t*>(act);
  a.acts = reinterpret_cast<float*>(static_cast<int8_t*>(act) +
                                    static_cast<size_t>(m) * f);
  a.out = static_cast<float*>(out);
  a.qkv = static_cast<float*>(qkv);
  a.stamps = static_cast<long long*>(stamps);
  a.plan = static_cast<const int*>(plan);
  a.m = m;
  a.qd = qd;
  a.h = h;
  a.f = f;
  a.nq = nq;
  a.eps = eps;
  return launch(a, true, blocks, smem, stream);
}

// The co-resident grid of K4 at row count m with `smem` bytes of dynamic
// shared memory (blocks, out through `blocks`, an int; at most two an SM):
// the wrapper sizes its split from it, and the P2 probe (csrc/q8_probe.cu)
// runs its walk on the grid K4 launches. Returns a cudaError_t.
extern "C" int q8_layer_fused_grid(int m, int smem, void* blocks) {
  return grid_of(m, smem, false, blocks);
}

// K7's co-resident grid, as q8_layer_fused_grid.
extern "C" int q8i_layer_fused_grid(int m, int smem, void* blocks) {
  return grid_of(m, smem, true, blocks);
}
