// The streaming q8_0 weight engine for Hopper (sm_90a): K5's GEMV stages
// and head (q8_decode_all.cu), K4's and K7's stages (q8_layer_fused.cu),
// and the decode-sized K1 / K6 product (q8_matmul.cu).
//
// A block's share of a q8_0 matrix is a slab of whole rows: a contiguous
// row range (gate_up: a range of gate rows and the same range of up rows),
// split across the grid by bytes in the wrapper (ops/quant_matmul.py
// q8_decode_all_split, a table of row starts per block). One thread asks
// the Tensor Memory Accelerator for the slab with bulk copies
// (cp.async.bulk ... mbarrier::complete_tx::bytes) into a slot of shared
// memory laid out as the slab's int8 rows [R, k] and then their f32 scales
// [R, k / 32]; with k % 128 == 0 both segments of every part are whole
// 16-byte words at 16-byte aligned addresses, as bulk copies require. The
// copy reports to the slot's mbarrier, so the block computes other stages,
// and waits at grid barriers, while the bytes arrive; the reader waits on
// the mbarrier's phase.
//
// The dot product reads the slot. Unit u of an R-row slab is (row u / nc,
// columns [512 (u % nc), 512 (u % nc + 1))), nc = ceil(k / 512). The warps
// of the block take the units in turn, so every warp has work however few
// rows the block holds (o and down: 3 or 4 rows a block, 4 and 6 units a
// row). The activation row sits in shared memory as f32. Each unit's warp
// sum lands in red[u]; a row's sum adds its units in order, so the result
// never depends on timing. Reading from shared memory, a stage is bound
// by the dequant's instructions: the int8 -> f32 step takes a byte
// permute and an add instead of a conversion instruction (the SM's
// conversion unit runs at a fraction of the FP32 rate), and two weights
// share one bf16x2 rounding; two units a warp are in flight at a time.
//
// Numerics as q8_gemv.cuh: q*d in f32 rounded to bf16 once, bf16 x, f32
// sums.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "q8_gemv.cuh"

namespace q8s {

using q8::kThreads;
using q8::kWarps;
using q8::warp_sum;

constexpr int kChunk = 512;   // columns of a unit: 4 x 32 lanes x 4

// bytes of an n-row slab of width k: int8 rows, then f32 scales
__host__ __device__ inline unsigned slab_bytes(int n, int k) {
  return static_cast<unsigned>(n) * static_cast<unsigned>(k + k / 8);
}

__host__ __device__ inline int units_per_row(int k) {
  return (k + kChunk - 1) / kChunk;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// an mbarrier that completes a phase on one arrival and its bytes
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(1)
               : "memory");
}

// after every bar_init of the block, before any use (then __syncthreads)
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// wait until the phase of parity `parity` of `bar` has completed; a copy
// that never lands (seconds of waiting) ends the launch with an error
// instead of holding the card
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done = 0;
  for (long long spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1ll << 28)) __trap();
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One thread: request rows [r0, r0 + n) of the q8_0 matrix (q [*, k], d
// [*, k / 32]) into `slot` on `bar`, and, when pair > 0, rows [r0 + pair,
// r0 + pair + n) after them (gate_up's up rows): slab rows [0, n) and [n,
// 2n). Arrives on `bar` expecting the slab's bytes; n = 0 arrives on an
// empty slab, so the phase completes and readers' parities stay in step.
// The fence orders the block's earlier generic-proxy accesses of the slot
// (read before a __syncthreads) before the copy's writes.
__device__ __forceinline__ void request(unsigned char* slot, uint64_t* bar,
                                        const int8_t* q, const float* d,
                                        int k, int r0, int n, int pair) {
  const int parts = pair > 0 ? 2 : 1;
  const int R = n * parts;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(slab_bytes(R, k))
               : "memory");
  if (n == 0) return;
  const unsigned qb = static_cast<unsigned>(n) * k;
  const unsigned db = static_cast<unsigned>(n) * (k / 8);
  for (int p = 0; p < parts; ++p) {
    const size_t row = static_cast<size_t>(r0) + static_cast<size_t>(p) * pair;
    bulk_load(slot + p * qb, q + row * k, qb, bar);
    bulk_load(slot + static_cast<size_t>(R) * k + p * db,
              d + row * (k >> 5), db, bar);
  }
}

// The same slab as request(..., pair) in parts: pairs [lo, hi) of it,
// gate and up rows (slab rows [lo, hi) and [n + lo, n + hi)). `last`: this
// part completes the phase (arrive.expect_tx with its bytes); else its
// bytes are only announced (expect_tx) and a later part arrives.
__device__ __forceinline__ void request_pairs(unsigned char* slot,
                                              uint64_t* bar, const int8_t* q,
                                              const float* d, int k, int r0,
                                              int n, int pair, int lo, int hi,
                                              bool last) {
  const int m = hi - lo;
  const unsigned bytes = slab_bytes(2 * m, k);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (last)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(smem_addr(bar)), "r"(bytes)
                 : "memory");
  else
    asm volatile(
        "mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(
            smem_addr(bar)),
        "r"(bytes)
        : "memory");
  if (m <= 0) return;
  for (int p = 0; p < 2; ++p) {
    const size_t row = static_cast<size_t>(r0) + lo +
                       static_cast<size_t>(p) * pair;
    const size_t at = static_cast<size_t>(p) * n + lo;   // slab row
    bulk_load(slot + at * k, q + row * k, m * k, bar);
    bulk_load(slot + static_cast<size_t>(2 * n) * k + at * (k / 8),
              d + row * (k >> 5), m * (k / 8), bar);
  }
}

// q8 + 128 of the low byte of w ^ 0x80808080 selected by `sel`, as the
// exact f32 value q: the byte under the exponent of 2^23 (one PRMT), less
// 2^23 + 128 (one FADD), no conversion instruction
__device__ __forceinline__ float q8_at(unsigned w, unsigned sel) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, sel)) - 8388736.f;
}

// Lane partial of unit (row r, columns c0 + 128 j + 0..3 for j = 0..3) of
// a slab: one 4-byte int8 word, its scale and a 16-byte float4 of x per j,
// conflict-free. Dequant without the conversion unit: q from the byte
// (q8_at), q*d in f32, each pair rounded to bf16 by one
// cvt.rn.bf16x2.f32 and unpacked by a shift and a mask. kFull: k % 512 ==
// 0, so every j is inside the row (no branch); else a j past k adds 0.
template <bool kFull>
__device__ __forceinline__ float unit_dot(const unsigned char* slot,
                                          const float* d, int r, int k,
                                          int c0, const float* x) {
  const unsigned* qw = reinterpret_cast<const unsigned*>(
      slot + static_cast<size_t>(r) * k);
  const float* dr = d + r * (k >> 5);
  unsigned w[4];
  float s[4];
  float4 xv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = c0 + 128 * j;
    if (kFull || c < k) {
      w[j] = qw[c >> 2] ^ 0x80808080u;
      s[j] = dr[c >> 5];
      xv[j] = *reinterpret_cast<const float4*>(x + c);
    } else {
      w[j] = 0x80808080u;   // q = 0 against x = 0
      s[j] = 0.f;
      xv[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  float acc[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(
        q8_at(w[j], 0x7540) * s[j], q8_at(w[j], 0x7541) * s[j]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(
        q8_at(w[j], 0x7542) * s[j], q8_at(w[j], 0x7543) * s[j]);
    const unsigned l = *reinterpret_cast<const unsigned*>(&lo);
    const unsigned h = *reinterpret_cast<const unsigned*>(&hi);
    float& a = acc[j & 1];
    a = fmaf(__uint_as_float(l << 16), xv[j].x, a);
    a = fmaf(__uint_as_float(l & 0xFFFF0000u), xv[j].y, a);
    a = fmaf(__uint_as_float(h << 16), xv[j].z, a);
    a = fmaf(__uint_as_float(h & 0xFFFF0000u), xv[j].w, a);
  }
  return acc[0] + acc[1];
}

template <bool kFull>
__device__ __forceinline__ void slab_dot_units(const unsigned char* slot,
                                               int R, int k, const float* x,
                                               float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nc = units_per_row(k), units = R * nc;
  const float* d = reinterpret_cast<const float*>(
      slot + static_cast<size_t>(R) * k);
  // two units a warp at a time (u, u + kWarps), so the loads of both are
  // in flight together; a missing second unit repeats the first, unused
  for (int u = warp; u < units; u += 2 * kWarps) {
    const int u2 = u + kWarps < units ? u + kWarps : u;
    const int r1 = u / nc, r2 = u2 / nc;
    const float v1 = unit_dot<kFull>(slot, d, r1, k,
                                     (u - r1 * nc) * kChunk + 4 * lane, x);
    const float v2 = unit_dot<kFull>(slot, d, r2, k,
                                     (u2 - r2 * nc) * kChunk + 4 * lane, x);
    const float s1 = warp_sum(v1), s2 = warp_sum(v2);
    if (lane == 0) {
      red[u] = s1;
      red[u2] = s2;
    }
  }
}

// red[u] = the warp sum of unit u of the R-row slab at `slot` against x
// (f32 [k], shared memory), every unit of the slab.
__device__ __forceinline__ void slab_dot(const unsigned char* slot, int R,
                                         int k, const float* x, float* red) {
  if (k % kChunk == 0) slab_dot_units<true>(slot, R, k, x, red);
  else slab_dot_units<false>(slot, R, k, x, red);
}

// The int8-dot contract (K6, q8_matmul.cu; K7, q8_layer_fused.cu): the
// weights against a q8_0 activation row, llama.cpp's q8_0 x q8_0 vec_dot
// as q8_slab.cuh states it: an exact int32 partial per 32-block, then * d_w * d_x in f32,
// summed in f32. No dequant: four MACs an instruction.

// the exact f32 of an int32 |z| < 2^22 (a block's partial is at most 32 x
// 128 x 127): z under the exponent of 1.5 x 2^23 (one IADD), less 1.5 x
// 2^23 (one FADD), no conversion instruction
__device__ __forceinline__ float i2f_exact(int z) {
  return __int_as_float(z + 0x4B400000) - 12582912.f;
}

// Lane share of unit (row r, columns [c - 16 lane, + 512)) of an int8 slab
// against the q8_0 row xq (int8 [k]) / xs (f32 [k / 32]) in shared memory:
// the lane's 16 bytes at c by four dp4a, its 32-block's exact partial with
// its neighbour's (lanes 2i and 2i + 1 hold one block), then, on the even
// lane, partial * d_w * d_x. kFull: k % 512 == 0; else a lane past k adds 0.
template <bool kFull>
__device__ __forceinline__ float unit_dot_i8(const unsigned char* slot,
                                             const float* d, int r, int k,
                                             int c, const int8_t* xq,
                                             const float* xs) {
  const bool in = kFull || c < k;
  int z = 0;
  if (in) {
    const int4 w = *reinterpret_cast<const int4*>(
        slot + static_cast<size_t>(r) * k + c);
    const int4 x = *reinterpret_cast<const int4*>(xq + c);
    z = __dp4a(w.x, x.x, 0);
    z = __dp4a(w.y, x.y, z);
    z = __dp4a(w.z, x.z, z);
    z = __dp4a(w.w, x.w, z);
  }
  z += __shfl_xor_sync(0xffffffffu, z, 1);
  if (!in || (threadIdx.x & 1)) return 0.f;
  const int b = c >> 5;
  return i2f_exact(z) * d[r * (k >> 5) + b] * xs[b];
}

// red[u] = the warp sum of unit u of the R-row int8 slab at `slot` against
// the q8_0 row (xq, xs), every unit of the slab: slab_dot's units and
// order, so repeated calls are equal bit for bit.
template <bool kFull>
__device__ __forceinline__ void slab_dot_i8_units(const unsigned char* slot,
                                                  int R, int k,
                                                  const int8_t* xq,
                                                  const float* xs,
                                                  float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nc = units_per_row(k), units = R * nc;
  const float* d = reinterpret_cast<const float*>(
      slot + static_cast<size_t>(R) * k);
  for (int u = warp; u < units; u += 2 * kWarps) {
    const int u2 = u + kWarps < units ? u + kWarps : u;
    const int r1 = u / nc, r2 = u2 / nc;
    const float v1 = unit_dot_i8<kFull>(
        slot, d, r1, k, (u - r1 * nc) * kChunk + 16 * lane, xq, xs);
    const float v2 = unit_dot_i8<kFull>(
        slot, d, r2, k, (u2 - r2 * nc) * kChunk + 16 * lane, xq, xs);
    const float s1 = warp_sum(v1), s2 = warp_sum(v2);
    if (lane == 0) {
      red[u] = s1;
      red[u2] = s2;
    }
  }
}

__device__ __forceinline__ void slab_dot_i8(const unsigned char* slot, int R,
                                            int k, const int8_t* xq,
                                            const float* xs, float* red) {
  if (k % kChunk == 0) slab_dot_i8_units<true>(slot, R, k, xq, xs, red);
  else slab_dot_i8_units<false>(slot, R, k, xq, xs, red);
}

// row r's dot product: its units' sums in order (after a __syncthreads)
__device__ __forceinline__ float row_sum(const float* red, int r, int nc) {
  float v = 0.f;
  for (int c = 0; c < nc; ++c) v += red[r * nc + c];
  return v;
}

// x [k] bf16, written inside this launch (read via L2), into shared memory
// as f32
__device__ __forceinline__ void load_x(const __nv_bfloat16* src, int k,
                                       float* xs) {
  for (int c = threadIdx.x * 8; c < k; c += kThreads * 8) {
    const uint4 v = __ldcg(reinterpret_cast<const uint4*>(src + c));
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(p[i]);
      xs[c + 2 * i] = f.x;
      xs[c + 2 * i + 1] = f.y;
    }
  }
}

// xs = f32(bf16((x * 1/sqrt(mean(x^2) + eps)) * w)) for the f32 row x [h]
// written inside this launch (read via L2), by the whole block; `part`:
// kWarps floats of shared memory. Ends with the block synchronised.
__device__ __forceinline__ void rms_to_xs(const float* x,
                                          const __nv_bfloat16* w, int h,
                                          float eps, float* xs, float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float ss = 0.f;
  for (int c = threadIdx.x * 4; c < h; c += kThreads * 4) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(x + c));
    *reinterpret_cast<float4*>(xs + c) = v;
    ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
  }
  ss = warp_sum(ss);
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) tot += part[i];
  const float inv = 1.f / sqrtf(tot / static_cast<float>(h) + eps);
  for (int c = threadIdx.x * 4; c < h; c += kThreads * 4) {
    const uint2 wr = __ldg(reinterpret_cast<const uint2*>(w + c));
    const __nv_bfloat16* wb = reinterpret_cast<const __nv_bfloat16*>(&wr);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      xs[c + i] = __bfloat162float(
          __float2bfloat16((xs[c + i] * inv) * __bfloat162float(wb[i])));
  }
  __syncthreads();
}

}  // namespace q8s
