// The slab helpers of the streaming q8_0 engine (q8_stream.cuh) that K4 /
// K4c / K7 (q8_layer_fused.cu) and the decode-sized product K1 / K6
// (q8_matmul.cu) share: the block-wide request of a slab or ring tile
// (fetch), the bf16 rows and q8_0 rows of the activations in shared memory
// (load_rows, quant_rows), and the two mma instructions with the dequant
// of a bf16 pair (mma16816 and deq2: bf16 m16n8k16; mma_s8: s8 m16n8k32,
// one mma a q8_0 block).
//
// The int8-dot contract is llama.cpp's q8_0 x q8_0 vec_dot, as JAX's
// quantize_act_q8 (fun_asr_gguf_tpu/ops/quant_matmul.py:1340) and
// _q8dot_ref (:1399) state it:
//   d = amax / 127 per 32-block (IEEE division), inv = 0 if d == 0 else 1/d,
//   q = sign(x * inv) * floor(|x * inv| + 0.5)   (ties away from zero);
//   partial = sum_t q_w[t] * q_x[t], exact in int32;
//   y += float(partial) * d_w * d_x, summed in f32.
// x * inv is taken with __fmul_rn so that nvcc cannot contract it into an
// FMA; nothing here may be built with -use_fast_math.
//
// The helpers keep internal linkage (an unnamed namespace, as where they
// were first written), so every kernel that includes them inlines its own
// copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "q8_stream.cuh"

namespace {

using q8::kThreads;
using q8::kWarps;
using namespace q8s;

constexpr int kSpan = 64;                 // columns of an mma span
constexpr int kGroup = 4;                 // 8-row tiles of an mma item

// Block-wide (every thread calls it): rows [r0, r0 + n) of (q, d) of width
// k into `slot` on `bar`, and with pair > 0 rows [r0 + pair, ...) after
// them (gate_up's up rows); the slab is int8 rows [R, k] then f32 scales
// [R, k / 32]. Thread 0 arrives on `bar` expecting the bulk bytes (n = 0
// arrives on an empty slab, so the phase completes); the fence orders the
// block's earlier generic reads of the slot before the copies. With k %
// 128 != 0 the scales go by plain loads: readers see them after the next
// __syncthreads.
__device__ void fetch(unsigned char* slot, uint64_t* bar, const int8_t* q,
                      const float* d, int k, size_t r0, int n, size_t pair) {
  const int parts = pair > 0 ? 2 : 1;
  const int R = n * parts;
  const bool bulk_d = k % 128 == 0;
  if (threadIdx.x == 0) {
    const unsigned bytes =
        bulk_d ? slab_bytes(R, k) : static_cast<unsigned>(R) * k;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(smem_addr(bar)), "r"(bytes)
                 : "memory");
    const unsigned qb = static_cast<unsigned>(n) * k;
    const unsigned db = static_cast<unsigned>(n) * (k / 8);
    for (int p = 0; p < parts && n > 0; ++p) {
      const size_t row = r0 + p * pair;
      bulk_load(slot + p * qb, q + row * k, qb, bar);
      if (bulk_d)
        bulk_load(slot + static_cast<size_t>(R) * k + p * db,
                  d + row * (k >> 5), db, bar);
    }
  }
  if (!bulk_d && n > 0) {
    float* ds = reinterpret_cast<float*>(slot + static_cast<size_t>(R) * k);
    const int nb = k >> 5;
    for (int i = threadIdx.x; i < R * nb; i += kThreads) {
      const int row = i / nb, p = row / n;
      ds[i] = __ldg(d + (r0 + p * pair + (row - p * n)) * nb + (i - row * nb));
    }
  }
}

__device__ __forceinline__ void mma16816(float (&c)[4], unsigned a0,
                                         unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// bf16x2 of two bytes of w ^ 0x80808080 (q8s::q8_at), each q*s rounded once
__device__ __forceinline__ unsigned deq2(unsigned w, unsigned lo,
                                         unsigned hi, float s) {
  const __nv_bfloat162 v =
      __floats2bfloat162_rn(q8_at(w, lo) * s, q8_at(w, hi) * s);
  return *reinterpret_cast<const unsigned*>(&v);
}

// bf16 rows src [m, k] (written in the launch or not; read via L2),
// columns [c0, c1), into X (`xstride` bytes a row)
__device__ void load_rows(const __nv_bfloat16* src, int m, int k, int c0,
                          int c1, unsigned char* X, int xstride) {
  const int w = (c1 - c0) / 8;
  for (int i = threadIdx.x; i < m * w; i += kThreads) {
    const int r = i / w, c = c0 + (i - r * w) * 8;
    *reinterpret_cast<uint4*>(X + r * xstride + (c - c0) * 2) =
        __ldcg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * k
                                              + c));
  }
}

// The q8_0 form of rows [0, m), columns [c0, c1), of the f32 values
// value(r, c) (a float4 of columns c .. c + 3) into the int8 rows X
// (`xstride` bytes apart, column c0 first) and their scales xs[b bs + r rs]
// (block b of the chunk; in shared memory rs = 1 and bs = 8 or 16 rows for
// the mma form at m <= 8 or m > 8, 1 for the one row of m = 1; rows [m,
// k / 32] in device memory: bs = 1, rs = k / 32). Four lanes a 32-block,
// eight values a lane, amax by two shuffles; d = amax / 127 (IEEE), q = v *
// (1 / d) rounded half away from zero, 0 where d = 0 (JAX's
// quantize_act_q8), so equal values give equal bytes whatever their
// source. Group g of four lanes takes the blocks g, g + 64, ... of the rows
// in row order, kQuantBatch of them in flight at a time (the rows come
// from L2: one round trip a batch, not one a block). At m > 1 a block is
// the SM's only one, so the instructions a block costs, not the lanes
// busy, set the time: the row and block of the next item are stepped, not
// divided, and the rounding takes one conversion. The caller syncs the
// block after.
constexpr int kQuantBatch = 4;

template <class F>
__device__ void quant_rows(F value, int m, int c0, int c1, unsigned char* X,
                           int xstride, float* xs, int bs, int rs) {
  constexpr int kGroups = kThreads / 4;   // four-lane groups of the block
  const int sub = threadIdx.x & 3, nb = (c1 - c0) >> 5, total = m * nb;
  int r = 0, b = threadIdx.x >> 2;         // this group's next item
  while (b >= nb && r < m) {
    b -= nb;
    ++r;
  }
  // every lane of a warp runs the same iterations: the shuffles see the
  // whole warp
  for (int i0 = 0; i0 < total; i0 += kQuantBatch * kGroups) {
    float4 v[kQuantBatch][2];
    int rb[kQuantBatch][2];
#pragma unroll
    for (int u = 0; u < kQuantBatch; ++u) {
      rb[u][0] = r;
      rb[u][1] = b;
      if (r < m) {
        const int c = c0 + 32 * b + 8 * sub;
        v[u][0] = value(r, c);
        v[u][1] = value(r, c + 4);
      } else {
        v[u][0] = v[u][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      for (b += kGroups; b >= nb && r < m; b -= nb) ++r;
    }
#pragma unroll
    for (int u = 0; u < kQuantBatch; ++u) {
      if (i0 + u * kGroups >= total) break;   // warp-uniform
      const float4 p = v[u][0], q = v[u][1];
      float amax = fmaxf(fmaxf(fmaxf(fabsf(p.x), fabsf(p.y)),
                               fmaxf(fabsf(p.z), fabsf(p.w))),
                         fmaxf(fmaxf(fabsf(q.x), fabsf(q.y)),
                               fmaxf(fabsf(q.z), fabsf(q.w))));
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
      const float d = amax / 127.0f;
      const float inv = d == 0.f ? 0.f : 1.0f / d;
      // round half away from zero: floor(|t| + 0.5) in one conversion
      auto q8 = [inv](float x) {
        const float t = __fmul_rn(x, inv);
        const int a = __float2int_rd(fabsf(t) + 0.5f);
        return static_cast<unsigned>(t < 0.f ? -a : a) & 0xFFu;
      };
      auto word = [&](float4 f) {
        return q8(f.x) | q8(f.y) << 8 | q8(f.z) << 16 | q8(f.w) << 24;
      };
      const int rr = rb[u][0], bb = rb[u][1];
      if (rr < m) {
        *reinterpret_cast<uint2*>(X + rr * xstride + 32 * bb + 8 * sub) =
            make_uint2(word(p), word(q));
        if (sub == 0) xs[bb * bs + rr * rs] = d;
      }
    }
  }
}

// c = the exact int32 product of one 16 x 32 int8 A tile and one 32 x 8 B
__device__ __forceinline__ void mma_s8(int (&c)[4], unsigned a0, unsigned a1,
                                       unsigned a2, unsigned a3, unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "r"(0),
        "r"(0), "r"(0), "r"(0));
}

}  // namespace
