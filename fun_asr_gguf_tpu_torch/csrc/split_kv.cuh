// Split-KV decode attention for Hopper (sm_90a): the device code of one
// chunk stage and of the combine, shared by K2 / K2-i8 (flash_decode.cu),
// K5's attention (q8_decode_all.cu) and the P12 probe (probes.cu).
//
// The work of one (kv head, batch row) is cut into chunks of cache slots;
// one block takes one chunk (a work item), so a call spreads over every SM
// instead of one block per kv head. The stage of a chunk serves all R query
// rows of its kv head (R = T * GQA group; R <= 32) and writes the chunk's
// partial state in f32: the row max m, the sum l of exp(s - m), and the
// unnormalised acc = sum bf16(exp(s - m) [* v_scale]) . v [R, 128].
//
// Inside the stage, tiles of 32 slots are staged into shared memory with
// cp.async, double-buffered: tile i + 1's K and V rows arrive while tile i
// is scored. The softmax over the chunk is online (running max, the sums
// rescaled by exp(m_old - m_new)). The products run on the tensor cores:
// mma.sync m16n8k16, bf16 in, f32 accumulate, the query rows padded to 16
// (MT = 1) or 32 (MT = 2): Q [rows, 128] . K^T [128, 32] for the scores and
// P [rows, 32] . V [32, 128] for the mix. An int8 cache converts to bf16
// exactly (|v| <= 127) when a fragment is formed.
//
// Masked slots: a tile whose bias values are all <= -1e29 (the callers'
// -1e30 mask) for every query row is skipped without reading its K or V
// rows: its terms exp(-1e30 - m) are 0 wherever the row has a visible slot.
// A chunk with no visible slot leaves m = -inf, l = 0, acc = 0, and the
// combine gives it weight 0. A query row with no visible slot at all is
// the one case that differs from the plain exact softmax (the mean of V
// over every slot): it gets the mean over the tiles the head's other rows
// see, or 0 when no row sees any. The decoders write the current token's
// row before they attend, so no caller passes such a row.
//
// The combine: the last block to finish a (kv head, batch row) learns it
// from an atomic ticket (after __threadfence), resets the ticket to 0 for
// the next call, and merges the partials in chunk order, so the result
// does not depend on the order in which blocks finish. An optional
// current-token term (K5, P12: m = s_cur, l = 1, acc = v_cur, all f32)
// starts the merged state.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "q8_warp.cuh"

namespace skv {

using q8::warp_max;
using q8::warp_sum;

constexpr int kHd = 128;           // head_dim
constexpr int kTile = 32;          // cache slots per staged tile
constexpr float kMasked = -1e29f;  // bias at or below: a masked slot

// Where a stage reads. Element type CT: __nv_bfloat16 or int8_t.
struct StageIn {
  const void* k;          // slot s of this (kv head, row) at k + s * stride
  const void* v;
  long long stride;       // elements between consecutive slots
  const __nv_bfloat16* ks;  // int8 cache: K / V scale of slot s at
  const __nv_bfloat16* vs;  //   ks[s * sstride]; null for bf16
  long long sstride;
  const float* bias;      // bias of query row r, slot s:
  long long tstride;      //   bias[(r / group) * tstride + s]
  int group;
  int R;                  // query rows (<= 16 * MT)
  float scale;            // multiplies every dot (K2: 1, q pre-scaled)
};

// Shared-memory layout of a stage (byte offsets; 16-byte aligned base).
template <typename CT, int MT>
struct Smem {
  static constexpr int kRows = 16 * MT;
  static constexpr int kQStride = kHd + 8;                    // bf16
  static constexpr int kKVStride = kHd * int(sizeof(CT)) + 16;  // bytes
  static constexpr int kSStride = kTile + 1;                  // f32
  static constexpr int kPStride = kTile + 8;                  // bf16
  static constexpr size_t q = 0;
  static constexpr size_t kbuf = q + size_t(kRows) * kQStride * 2;
  static constexpr size_t vbuf = kbuf + 2ull * kTile * kKVStride;
  static constexpr size_t sc = vbuf + 2ull * kTile * kKVStride;
  static constexpr size_t p = sc + size_t(kRows) * kSStride * 4;
  static constexpr size_t bias = p + size_t(kRows) * kPStride * 2;
  static constexpr size_t scl = bias + 2ull * kRows * kTile * 4;
  static constexpr size_t st = scl + 2ull * 2 * kTile * 4;
  static constexpr size_t flag = st + 3ull * kRows * 4;
  static constexpr size_t bytes = flag + 16;
  static_assert(kbuf % 16 == 0 && vbuf % 16 == 0 && kKVStride % 16 == 0,
                "cp.async destinations must be 16-byte aligned");
  // the combine's scratch (kMaxSplits x kRows pairs, the row sums, group
  // sums for up to 256 threads) fits from kbuf up to the row state
  static_assert((2 * 64 * kRows + 2 * kRows + 4 * 256) * 4 <= st - kbuf,
                "the combine's scratch must fit in the stage's tiles");
};

// The query rows of a stage: bf16 [16 MT][kQStride] at the start of its
// shared memory; rows >= R are never read into a result.
__device__ __forceinline__ __nv_bfloat16* q_rows(unsigned char* smem) {
  return reinterpret_cast<__nv_bfloat16*>(smem);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;   // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// two consecutive cache values (bf16 pair, or int8 pair -> bf16, exact)
__device__ __forceinline__ uint32_t pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pair(const int8_t* p) {
  return pack_bf16(__float2bfloat16(static_cast<float>(p[0])),
                   __float2bfloat16(static_cast<float>(p[1])));
}
// one cache value as bf16
__device__ __forceinline__ __nv_bfloat16 one(const __nv_bfloat16* p) {
  return *p;
}
__device__ __forceinline__ __nv_bfloat16 one(const int8_t* p) {
  return __float2bfloat16(static_cast<float>(*p));
}

// Stage tile [ts, ts + 32) of the chunk [., s1) into buffer buf: bias rows
// and scales by plain loads, K and V rows by cp.async (one commit group,
// empty when the tile is skipped). Returns whether any query row sees a
// slot of the tile; every thread of the block must call it.
template <typename CT, int MT, int NT>
__device__ __forceinline__ bool load_tile(const StageIn& in, int ts, int s1,
                                          int buf, unsigned char* smem) {
  using L = Smem<CT, MT>;
  constexpr bool kQuant = std::is_same<CT, int8_t>::value;
  const int tid = threadIdx.x;
  const int n_t = (in.R + in.group - 1) / in.group;   // bias rows
  float* bias = reinterpret_cast<float*>(smem + L::bias) +
                buf * L::kRows * kTile;
  bool any = false;
  for (int i = tid; i < n_t * kTile; i += NT) {
    const int t = i / kTile, j = i % kTile, s = ts + j;
    const float b = s < s1 ? __ldg(in.bias + t * in.tstride + s) : -INFINITY;
    bias[i] = b;
    any |= b > kMasked;
  }
  if constexpr (kQuant) {
    float* scl = reinterpret_cast<float*>(smem + L::scl) + buf * 2 * kTile;
    for (int j = tid; j < kTile; j += NT) {
      const int s = ts + j;
      const bool ok = s < s1;
      scl[j] = ok ? __bfloat162float(in.ks[s * in.sstride]) : 0.f;
      scl[kTile + j] = ok ? __bfloat162float(in.vs[s * in.sstride]) : 0.f;
    }
  }
  const bool vis = __syncthreads_or(any);
  if (vis) {
    constexpr int kChunks = kHd * int(sizeof(CT)) / 16;   // per slot row
    unsigned char* kd = smem + L::kbuf + size_t(buf) * kTile * L::kKVStride;
    unsigned char* vd = smem + L::vbuf + size_t(buf) * kTile * L::kKVStride;
    const CT* kb = static_cast<const CT*>(in.k);
    const CT* vb = static_cast<const CT*>(in.v);
    for (int i = tid; i < kTile * kChunks; i += NT) {
      const int j = i / kChunks, c = i % kChunks, s = ts + j;
      const bool ok = s < s1;
      const long long off = static_cast<long long>(ok ? s : ts) * in.stride +
                            c * (16 / int(sizeof(CT)));
      cp_async16(kd + j * L::kKVStride + c * 16, kb + off, ok);
      cp_async16(vd + j * L::kKVStride + c * 16, vb + off, ok);
    }
  }
  cp_async_commit();
  return vis;
}

// Scores, online softmax and the mix of one staged tile (NW warps).
template <typename CT, int MT, int NW>
__device__ __forceinline__ void tile_step(const StageIn& in, int buf,
                                          unsigned char* smem,
                                          float (&acc)[MT][16 / NW][4]) {
  using L = Smem<CT, MT>;
  constexpr bool kQuant = std::is_same<CT, int8_t>::value;
  constexpr int kNpw = 16 / NW;            // mix n-tiles (8 columns) per warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const __nv_bfloat16* qs = q_rows(smem);
  const CT* kt = reinterpret_cast<const CT*>(
      smem + L::kbuf + size_t(buf) * kTile * L::kKVStride);
  const CT* vt = reinterpret_cast<const CT*>(
      smem + L::vbuf + size_t(buf) * kTile * L::kKVStride);
  constexpr int kKVElems = L::kKVStride / int(sizeof(CT));   // row stride
  float* sc = reinterpret_cast<float*>(smem + L::sc);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(smem + L::p);
  const float* bias = reinterpret_cast<const float*>(smem + L::bias) +
                      buf * L::kRows * kTile;
  const float* scl = reinterpret_cast<const float*>(smem + L::scl) +
                     buf * 2 * kTile;
  float* st_m = reinterpret_cast<float*>(smem + L::st);
  float* st_l = st_m + L::kRows;
  float* st_a = st_l + L::kRows;

  // scores: output tiles (m-tile, 8 slots), MT x 4 of them over the warps
  for (int o = warp; o < MT * 4; o += NW) {
    const int mt = o >> 2, nt = o & 3;
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    const CT* krow = kt + (nt * 8 + g) * kKVElems;
#pragma unroll
    for (int kk = 0; kk < kHd / 16; ++kk) {
      const __nv_bfloat16* qa = qs + (mt * 16 + g) * L::kQStride + kk * 16 +
                                2 * tq;
      const uint32_t a[4] = {
          pair(qa), pair(qa + 8 * L::kQStride), pair(qa + 8),
          pair(qa + 8 * L::kQStride + 8)};
      const CT* kb = krow + kk * 16 + 2 * tq;
      mma_bf16(d, a, pair(kb), pair(kb + 8));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = mt * 16 + g + (e >> 1) * 8, j = nt * 8 + 2 * tq + (e & 1);
      if (r < in.R) {
        float s = d[e] * in.scale;
        if constexpr (kQuant) s *= scl[j];
        sc[r * L::kSStride + j] = s + bias[(r / in.group) * kTile + j];
      }
    }
  }
  __syncthreads();

  // online softmax: one warp per row, one slot per lane
  for (int r = warp; r < L::kRows; r += NW) {
    float pv = 0.f;
    if (r < in.R) {
      const float s = sc[r * L::kSStride + lane];
      const float m_old = st_m[r];
      const float m_new = fmaxf(m_old, warp_max(s));
      const bool none = m_new == -INFINITY;
      const float alpha = none ? 1.f : expf(m_old - m_new);
      const float p = none ? 0.f : expf(s - m_new);
      const float lsum = warp_sum(p);
      if (lane == 0) {
        st_m[r] = m_new;
        st_l[r] = st_l[r] * alpha + lsum;
        st_a[r] = alpha;
      }
      pv = p;
      if constexpr (kQuant) pv *= scl[kTile + lane];   // V's scale, then
    }                                                  // the bf16 rounding
    ps[r * L::kPStride + lane] = __float2bfloat16(pv);
  }
  __syncthreads();

  // mix: warp w owns columns [8 kNpw w, 8 kNpw (w + 1)) of every row
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float a0 = st_a[mt * 16 + g], a1 = st_a[mt * 16 + g + 8];
#pragma unroll
    for (int j = 0; j < kNpw; ++j) {
      acc[mt][j][0] *= a0;
      acc[mt][j][1] *= a0;
      acc[mt][j][2] *= a1;
      acc[mt][j][3] *= a1;
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const __nv_bfloat16* pa = ps + (mt * 16 + g) * L::kPStride + kk * 16 +
                                2 * tq;
      const uint32_t a[4] = {
          pair(pa), pair(pa + 8 * L::kPStride), pair(pa + 8),
          pair(pa + 8 * L::kPStride + 8)};
      const CT* v0 = vt + (kk * 16 + 2 * tq) * kKVElems;
#pragma unroll
      for (int j = 0; j < kNpw; ++j) {
        const int col = (warp * kNpw + j) * 8 + g;
        const uint32_t b0 = pack_bf16(one(v0 + col), one(v0 + kKVElems + col));
        const uint32_t b1 = pack_bf16(one(v0 + 8 * kKVElems + col),
                                      one(v0 + 9 * kKVElems + col));
        mma_bf16(acc[mt][j], a, b0, b1);
      }
    }
  }
}

// The stage of one chunk [s0, s1): the query rows are in q_rows(smem)
// (bf16, rows >= R padded); writes m, l [R] and acc [R][128] of the chunk
// to pm / pl / pacc. NW warps; every thread of the block calls it.
template <typename CT, int MT, int NW>
__device__ void stage(const StageIn& in, int s0, int s1, unsigned char* smem,
                      float* pm, float* pl, float* pacc) {
  using L = Smem<CT, MT>;
  constexpr int kNpw = 16 / NW;
  static_assert(NW == 4 || NW == 8, "the mix maps 16 column tiles to warps");
  float* st_m = reinterpret_cast<float*>(smem + L::st);
  float* st_l = st_m + L::kRows;
  for (int r = threadIdx.x; r < L::kRows; r += NW * 32) {
    st_m[r] = -INFINITY;
    st_l[r] = 0.f;
    st_l[L::kRows + r] = 1.f;     // alpha; rows >= R keep it
  }
  float acc[MT][kNpw][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < kNpw; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  const int ntiles = (s1 - s0 + kTile - 1) / kTile;
  bool vis = load_tile<CT, MT, NW * 32>(in, s0, s1, 0, smem);
  for (int i = 0; i < ntiles; ++i) {
    const int buf = i & 1;
    bool vis_next = false;
    if (i + 1 < ntiles)
      vis_next = load_tile<CT, MT, NW * 32>(in, s0 + (i + 1) * kTile, s1,
                                            buf ^ 1, smem);
    else
      cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (vis) tile_step<CT, MT, NW>(in, buf, smem, acc);
    __syncthreads();
    vis = vis_next;
  }
  cp_async_wait<0>();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  for (int r = threadIdx.x; r < in.R; r += NW * 32) {
    pm[r] = st_m[r];
    pl[r] = st_l[r];
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < kNpw; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = mt * 16 + g + (e >> 1) * 8;
        const int c = (warp * kNpw + j) * 8 + 2 * tq + (e & 1);
        if (r < in.R) pacc[r * kHd + c] = acc[mt][j][e];
      }
}

// After a block wrote its partial: whether it is the last of the n blocks
// that share the ticket. The last one resets the ticket for the next call.
// sflag: one int of shared memory. Every thread of the block calls it.
__device__ __forceinline__ bool last_block(int* ticket, int n, int* sflag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool last = atomicAdd(ticket, 1) == n - 1;
    if (last) atomicExch(ticket, 0);
    *sflag = last;
  }
  __syncthreads();
  const bool last = *sflag != 0;
  if (last) __threadfence();
  return last;
}

// Merge n <= kMaxSplits chunk partials of R rows (partial i of row r:
// pm[i R + r], pl[i R + r], pacc[(i R + r) 128 + d], 16-byte aligned,
// written by other blocks: read through L2) in chunk order, started from
// the current token's term when cur_s is given (cur_s [R], cur_v [128],
// shared memory). scratch: combine_floats(n, R) floats of shared memory
// that the stage no longer needs. out(r, d, value) writes row r.
//
// The weights exp(m_i - M) and the merged sums L come first, one warp per
// row, from m and l staged in shared memory; then the threads take (row,
// 4 columns) items, and when there are fewer items than threads, groups
// of threads take every G-th chunk and their sums meet in shared memory
// in a fixed order. The loads of a thread are independent (float4, no
// branch), so many are in flight at once.
constexpr int kMaxSplits = 64;

__host__ __device__ inline int combine_floats(int n, int R, int nthreads) {
  const int items = R * (kHd / 4);
  const int groups = nthreads / items > 1 ? nthreads / items : 1;
  return 2 * n * R + 2 * R + (groups > 1 ? groups * items * 4 : 0);
}

template <class Out>
__device__ void combine(const float* pm, const float* pl, const float* pacc,
                        int n, int R, const float* cur_s, const float* cur_v,
                        float* scratch, Out out) {
  const int nt = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  float* w = scratch;              // [n][R]: m, then the weights
  float* lw = w + n * R;           // [n][R]: l
  float* row_l = lw + n * R;       // [R]: the merged sum
  float* row_c = row_l + R;        // [R]: the current token's weight
  float* red = row_c + R;          // [G][R][128] group sums
  for (int i = tid; i < n * R; i += nt) {
    w[i] = __ldcg(pm + i);
    lw[i] = __ldcg(pl + i);
  }
  __syncthreads();
  for (int r = warp; r < R; r += nw) {
    float mx = cur_s ? cur_s[r] : -INFINITY;
    for (int i = lane; i < n; i += 32) mx = fmaxf(mx, w[i * R + r]);
    mx = warp_max(mx);
    float l = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float mi = w[i * R + r];
      const float wi = mi == -INFINITY ? 0.f : expf(mi - mx);
      w[i * R + r] = wi;
      l += wi * lw[i * R + r];
    }
    l = warp_sum(l);
    if (lane == 0) {
      const float wc = cur_s ? expf(cur_s[r] - mx) : 0.f;
      row_c[r] = wc;
      row_l[r] = l + wc;
    }
  }
  __syncthreads();
  const int items = R * (kHd / 4);
  const int groups = nt / items > 1 ? nt / items : 1;
  for (int it = tid; it < items * groups; it += nt) {
    const int item = it % items, grp = it / items;
    const int r = item / (kHd / 4), c4 = item % (kHd / 4);
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int i = grp; i < n; i += groups) {
      const float wi = w[i * R + r];
      const float4 a = __ldcg(reinterpret_cast<const float4*>(
          pacc + (static_cast<size_t>(i) * R + r) * kHd) + c4);
      o.x = fmaf(wi, a.x, o.x);
      o.y = fmaf(wi, a.y, o.y);
      o.z = fmaf(wi, a.z, o.z);
      o.w = fmaf(wi, a.w, o.w);
    }
    if (groups > 1) {
      reinterpret_cast<float4*>(red)[grp * items + item] = o;
    } else {
      const float l = row_l[r], wc = row_c[r];
      const float inv = l > 0.f ? 1.f / l : 0.f;
      const float ov[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * c4 + e;
        out(r, d, (ov[e] + (cur_s ? wc * cur_v[d] : 0.f)) * inv);
      }
    }
  }
  if (groups == 1) return;
  __syncthreads();
  for (int item = tid; item < items; item += nt) {
    const int r = item / (kHd / 4), c4 = item % (kHd / 4);
    float ov[4] = {0.f, 0.f, 0.f, 0.f};
    for (int g = 0; g < groups; ++g) {
      const float4 a = reinterpret_cast<const float4*>(red)[g * items + item];
      ov[0] += a.x;
      ov[1] += a.y;
      ov[2] += a.z;
      ov[3] += a.w;
    }
    const float l = row_l[r], wc = row_c[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * c4 + e;
      out(r, d, (ov[e] + (cur_s ? wc * cur_v[d] : 0.f)) * inv);
    }
  }
}

// The first byte of a stage's shared memory that the combine may use as
// scratch (the staged tiles and everything after them up to the row
// state, which the stage no longer reads once its partial is written).
template <typename CT, int MT>
__device__ __forceinline__ float* combine_scratch(unsigned char* smem) {
  return reinterpret_cast<float*>(smem + Smem<CT, MT>::kbuf);
}

// Slots per chunk: enough chunks that `items` work items (kv heads x batch
// rows) fill `blocks` blocks, in whole tiles, never more than the tiles.
__host__ __device__ inline int chunk_slots(int S, int items, int blocks) {
  const int tiles = (S + kTile - 1) / kTile;
  int splits = (blocks + items - 1) / items;
  if (splits < 1) splits = 1;
  if (splits > tiles) splits = tiles;
  if (splits > kMaxSplits) splits = kMaxSplits;
  return kTile * ((tiles + splits - 1) / splits);
}

}  // namespace skv
