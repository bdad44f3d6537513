// K5 — the whole b = 1 q8_0 decode step of a Qwen3 decoder for Hopper
// (sm_90a), in ONE cooperative launch: every layer's qkv, qk-norm, rope,
// GQA-2 attention over a head-major bf16 cache, o + residual, post norm,
// gate_up, SiLU gate, down + residual and the next layer's input norm
// (the final norm after the last layer), then the q8_0 lm_head.
//
// Replaces the Pallas kernel fun_asr_gguf_tpu/ops/quant_matmul.py
// q8_decode_all_fused (:1970, pallas_call :2114; body
// _q8_decode_all_kernel :1773), in natural GGUF order: the TPU's perm space
// and its E-matrix scale expansion do not exist here. Per layer l:
//
//   qkv  = nh . qkv_w[l]^T                                  (f32)
//   q, k = rope(rmsnorm(q) * q_norm[l]), rope(rmsnorm(k) * k_norm[l])  (f32)
//   attention per kv head, query heads 2hh and 2hh+1:
//     the current token in f32: s = q.k_cur * scale, weight exp(s - M),
//     value v_cur; the cached slots: bf16(q).k * scale + bias, per chunk
//     p = exp(. - m_chunk) summed in f32 and rounded to bf16 for p.v; the
//     chunks merged with weights exp(m_chunk - M); xm = bf16(acc / l)
//   h1   = xm . o[l]^T + res                                (f32)
//   act  = bf16(silu(nh1 . gate^T) * (nh1 . up^T)), nh1 = bf16(rmsnorm(h1)
//          * post_ln[l])
//   res  = act . down[l]^T + h1                             (f32)
//   nh   = bf16(rmsnorm(res) * norms_next[l])
// and logits = nh . head^T after the last layer. The residual stays f32
// across all layers (the per-layer K4 path rounds it to bf16 between
// layers). The new k/v rows come back in f32 (k_new, v_new [L, kh, D]);
// the caller writes them into the cache at the step's slot, so the kernel
// never writes the cache it reads. Every q*d is formed in f32 and rounded
// to bf16 once (the port's K1/K4 convention; the Pallas body rounds d to
// bf16 first).
//
// What bounds it: bytes. At Qwen3-0.6B width one step reads 495.45 MB of
// layer weights (int8 + f32 scales: qkv 4096x1024, o 1024x2048, gate_up
// 6144x1024, down 1024x3072, x 28), the 175.77 MB head (152576x1024) and
// 114688 B of bf16 cache per visible slot (88.08 MB at S = 768): about
// 759 MB, 0.227 ms at 3.35 TB/s. Its ~1.2 GFLOP are negligible.
//
// Design. One launch sized to co-residency (two blocks an SM), with a
// grid-wide barrier between stages that need a whole previous row: qkv |
// attention | o | norm + gate_up | down, five per layer (140 at 28
// layers). The TPU kernel's sequential grid keeps the next weight chunk's
// DMA in flight across its stage boundaries; here the weight stream runs
// through the grid barriers instead (q8_stream.cuh): each block owns a
// slab of whole rows of each matrix, split by bytes in the wrapper (a
// table of row starts, `split`), and its thread 0 requests each slab by
// bulk asynchronous copy (TMA) into a two-slot shared-memory ring at least
// one grid barrier before the stage that reads it:
//
//   slot 0: qkv[l]      requested during down[l-1] (l = 0: at the start)
//           gate_up[l]  half requested at the start of attention[l], half
//                       during o[l]
//   slot 1: o[l]        requested after down[l-1]'s barrier, with the
//                       next norm (l = 0: at the start)
//           down[l]     requested during gate_up[l], after its norm
//
// Each request goes out just after a grid barrier and after the stage's
// own reads through L2, never just before a barrier: the copies of 264
// blocks form a burst of up to 7 MB, and whatever latency-bound access
// queues behind it (a barrier's atomics, the activation row) waits for it
// to drain. So no block starts a stage cold: its slab waits in shared
// memory. The head streams through a deeper ring of 16-row tiles over the
// attention region and slot 0, its first tiles requested during the last
// layer's down; each tile's slot is requested again as soon as its rows
// are done. The stages read the weights from shared memory, every warp of
// the block on every slab (q8_stream.cuh slab_dot), with the activation
// row staged in shared memory as f32. After a barrier each block
// recomputes the 1024-wide RMSNorm of the f32 row into its own shared
// memory (all warps) instead of paying another barrier.
//
// Attention is split-KV over every block (split_kv.cuh, the stage K2
// runs): the work items are (kv head, chunk of the visible span of cache
// slots), sized so that the heads' chunks about fill the grid (Span); each block recomputes the two
// roped query rows of its head, stages its chunk's K and V tiles with
// cp.async, scores and mixes them with mma.sync (probabilities rounded to
// bf16 unnormalised, as JAX's chunked stage does, quant_matmul.py
// :1870-1880) and writes the chunk's (m, l, acc); the last block of a head
// (an atomic ticket, no extra grid barrier) merges the chunks in order,
// started from the current token's f32 term (m = s_cur, l = 1, acc =
// v_cur), into xm. A tile whose bias is -1e29 or below for every slot (the
// callers' -1e30 mask) is skipped without reading its K or V rows: the
// cache bytes a step reads are those of its visible tiles. The shared
// memory does not grow with S.
//
// The stage timer (a non-null `stamps`, a measurement, never on the decode
// path): thread 0 of block 0 writes its SM's clock64 at the start, after
// each of the 140 grid barriers and after its share of the head, and the
// global nanosecond timer at the start and the end, which converts cycles
// to time. Each interval between two barriers is one stage's wall time as
// block 0 sees it: the slowest block's work of that stage plus the
// barrier. Off, it costs one predicated branch per barrier.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

#include "q8_gemv.cuh"
#include "q8_stream.cuh"
#include "split_kv.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace q8;
using namespace q8s;

constexpr int kHd = 128;               // head_dim: 32 lanes x 4 columns
constexpr int kMaxBlocksPerSm = 2;     // fewer blocks, cheaper grid barriers
constexpr int kMaxHeadTiles = 16;      // the head ring's depth, at most
static_assert(kWarps >= 4, "warps 0..3 form the current token's rows");

// the split table's rows: row (pair) starts per block, [kMats][grid + 1]
enum Mat { kQkv = 0, kO, kGateUp, kDown, kHead, kMats };

struct Args {
  const float* x0;               // [h]          embedding row, f32
  const __nv_bfloat16* nhb0;     // [h]          bf16(input_ln[0] norm of x0)
  const __nv_bfloat16* post;     // [L, h]
  const __nv_bfloat16* nnext;    // [L, h]       input_ln[l+1]; final_ln last
  const __nv_bfloat16* qn;       // [L, D]
  const __nv_bfloat16* kn;       // [L, D]
  const float* cos;              // [D]          this position, f32
  const float* sin;              // [D]
  const float* bias;             // [S]          0 visible, -1e30 masked
  const __nv_bfloat16* kc;       // [L, kh, S, D] head-major cache
  const __nv_bfloat16* vc;
  const int8_t* qkvq;            // [L, nq, h] + [L, nq, h/32] f32
  const float* qkvd;
  const int8_t* oq;              // [L, h, qd]
  const float* od;
  const int8_t* gq;              // [L, 2f, h]   gate rows, then up rows
  const float* gd;
  const int8_t* dq;              // [L, h, f]
  const float* dd;
  const int8_t* hq;              // [vp, h]
  const float* hd;
  float* qkv;                    // scratch [nq]
  __nv_bfloat16* xm;             // scratch [qd]
  float* res;                    // scratch [h]
  float* h1;                     // scratch [h]
  __nv_bfloat16* act;            // scratch [f]
  float* logits;                 // [vp]
  float* k_new;                  // [L, kh, D]
  float* v_new;                  // [L, kh, D]
  float* att;                    // chunk partials: acc [kh][nch][2][D],
                                 // m, l [kh][nch][2]
  int* tickets;                  // [kh], 0 between calls
  int L, h, qd, f, kh, S, vp;
  float eps, scale;
  long long* stamps;             // the stage timer [5 L + 4], or null
  const int* split;              // [kMats][grid + 1] row (pair) starts
  unsigned slot0, slot1;         // the ring's slot bytes
  int red;                       // floats of one unit-sum buffer
  int head_rows, head_tiles;     // rows of a head tile, tiles in its ring
};

// stamps[i] = clock64() on block 0's thread 0, when the timer is on
__device__ __forceinline__ void stamp(const Args& a, int i) {
  if (a.stamps && blockIdx.x == 0 && threadIdx.x == 0) a.stamps[i] = clock64();
}

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

using AttSmem = skv::Smem<__nv_bfloat16, 1>;   // the chunk stage's layout

// Floats of shared memory after the stage's: the roped q rows in f32
// [2][D], the current token's k and v [D] each, s_cur [2] (+ 2 pad).
constexpr int kAuxFloats = 4 * kHd + 4;

// Roped q (warp < 2, row g = warp) or k (warp == 2) of kv head hh in layer
// l, f32: qk-norm then rope; lane owns columns 4*lane..4*lane+3, and the
// rope partner (column d +- 64) sits in lane ^ 16.
__device__ __forceinline__ void rope_row(const Args& a, int l, int hh,
                                         int warp, float (&y)[4]) {
  constexpr int D = kHd;
  const int lane = threadIdx.x & 31;
  const int off = warp < 2 ? (2 * hh + warp) * D : a.qd + hh * D;
  const __nv_bfloat16* nw = (warp < 2 ? a.qn : a.kn) + l * D;
  const float4 v4 = __ldcg(reinterpret_cast<const float4*>(
      a.qkv + off + 4 * lane));
  float x[4] = {v4.x, v4.y, v4.z, v4.w};
  const float ss = warp_sum(x[0] * x[0] + x[1] * x[1] + x[2] * x[2]
                            + x[3] * x[3]);
  const float inv = 1.f / sqrtf(ss / static_cast<float>(D) + a.eps);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[i] = (x[i] * inv) * __bfloat162float(nw[4 * lane + i]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float p = __shfl_xor_sync(0xffffffffu, x[i], 16);
    const int d = 4 * lane + i;
    y[i] = x[i] * __ldg(a.cos + d) + (lane < 16 ? -p : p) * __ldg(a.sin + d);
  }
}

struct OutXm {                    // xm[(2 hh + g) D + d] for query row g
  __nv_bfloat16* xm;
  int hh;
  __device__ void operator()(int g, int d, float v) const {
    xm[(2 * hh + g) * kHd + d] = __float2bfloat16(v);
  }
};

// One attention work item of layer l: kv head hh (query heads 2hh, 2hh+1)
// over cache slots [c chunk, (c + 1) chunk), through the shared chunk
// stage; the last item of the head merges the chunks, started from the
// current token's f32 term, into xm and writes k_new / v_new[l, hh].
// The attention items' range: the cache slots [base, end) from the first
// to the last visible slot's tile, cut into nch chunks of `chunk` slots
// (whole tiles) so that kv heads x chunks about fill the grid. Every
// block finds the same span from the bias row at the start of the launch,
// so a step of few visible slots makes few items, and a CUDA graph can
// capture the step (no host value).
struct Span {
  int base, end, chunk, nch;
};

// `word`: two ints of shared memory; ends with the block synchronised
__device__ Span visible_span(const Args& a, int* word) {
  constexpr int T = skv::kTile;
  if (threadIdx.x == 0) {
    word[0] = a.S;
    word[1] = -1;
  }
  __syncthreads();
  int lo = a.S, hi = -1;
  for (int j = threadIdx.x; j < a.S; j += kThreads)
    if (__ldg(a.bias + j) > skv::kMasked) {
      lo = min(lo, j);
      hi = max(hi, j);
    }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if ((threadIdx.x & 31) == 0) {
    atomicMin(word, lo);
    atomicMax(word + 1, hi);
  }
  __syncthreads();
  lo = word[0];
  hi = word[1];
  Span sp;
  if (hi < 0) {   // no visible slot: one masked tile, the current token alone
    sp.base = 0;
    sp.end = min(a.S, T);
  } else {
    sp.base = lo / T * T;
    sp.end = min(a.S, (hi / T + 1) * T);
  }
  sp.chunk = skv::chunk_slots(sp.end - sp.base, a.kh, gridDim.x);
  sp.nch = (sp.end - sp.base + sp.chunk - 1) / sp.chunk;
  __syncthreads();
  return sp;
}

__device__ void attend_item(const Args& a, const Span& sp, int l, int hh,
                            int c, unsigned char* sm) {
  constexpr int D = kHd;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* aux = reinterpret_cast<float*>(sm + AttSmem::bytes);
  float* qf = aux;                 // [2][D]
  float* kcur = qf + 2 * D;        // [D]
  float* vcur = kcur + D;          // [D]
  float* scur = vcur + D;          // [2]
  const size_t row = static_cast<size_t>(l) * a.kh + hh;

  // the two roped query rows: f32 (the current token's score) and bf16
  // (the cached slots' scores), stage rows 2..15 padding; beside them, so
  // that the merging block finds them ready, the current token's roped k
  // (warp 2) and v (warp 3) in f32
  float cur[4] = {0.f, 0.f, 0.f, 0.f};
  if (warp < 2) {
    float y[4];
    rope_row(a, l, hh, warp, y);
    __nv_bfloat16* qb = skv::q_rows(sm) + warp * AttSmem::kQStride;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qf[warp * D + 4 * lane + i] = y[i];
      qb[4 * lane + i] = __float2bfloat16(y[i]);
    }
  } else if (warp == 2) {
    rope_row(a, l, hh, 2, cur);
#pragma unroll
    for (int i = 0; i < 4; ++i) kcur[4 * lane + i] = cur[i];
  } else if (warp == 3) {
    const float4 v4 = __ldcg(reinterpret_cast<const float4*>(
        a.qkv + a.qd + (a.kh + hh) * D + 4 * lane));
    cur[0] = v4.x;
    cur[1] = v4.y;
    cur[2] = v4.z;
    cur[3] = v4.w;
#pragma unroll
    for (int i = 0; i < 4; ++i) vcur[4 * lane + i] = cur[i];
  }

  skv::StageIn in;
  in.k = a.kc + row * a.S * D;
  in.v = a.vc + row * a.S * D;
  in.stride = D;
  in.ks = in.vs = nullptr;
  in.sstride = 0;
  in.bias = a.bias;
  in.tstride = 0;
  in.group = 2;
  in.R = 2;
  in.scale = a.scale;
  const int nch = sp.nch;
  // att: acc [kh][nch][2][D], then m [kh][nch][2], then l
  float* pacc = a.att + hh * nch * 2 * D;
  float* pm = a.att + a.kh * nch * 2 * D + hh * nch * 2;
  float* pl = pm + a.kh * nch * 2;
  const int s0 = sp.base + c * sp.chunk, s1 = min(sp.end, s0 + sp.chunk);
  skv::stage<__nv_bfloat16, 1, kWarps>(in, s0, s1, sm, pm + c * 2,
                                       pl + c * 2, pacc + c * 2 * D);
  // the block that merges: the last of the head's items by its ticket, or
  // the only one (no atomic round trip)
  bool merge = nch == 1;
  if (merge) {
    __threadfence();
    __syncthreads();
  } else {
    merge = skv::last_block(a.tickets + hh, nch,
                            reinterpret_cast<int*>(sm + AttSmem::flag));
  }
  if (merge) {
    // the current token's k and v rows out; s_cur of query row g = warp
    // in f32 (the stage's barriers made kcur visible)
    if (warp == 2 || warp == 3) {
      float* out = (warp == 2 ? a.k_new : a.v_new) + row * D + 4 * lane;
#pragma unroll
      for (int i = 0; i < 4; ++i) out[i] = cur[i];
    } else if (warp < 2) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s += qf[warp * D + 4 * lane + i] * kcur[4 * lane + i];
      s = warp_sum(s);
      if (lane == 0) scur[warp] = s * a.scale;
    }
    __syncthreads();
    skv::combine(pm, pl, pacc, nch, 2, scur, vcur,
                 skv::combine_scratch<__nv_bfloat16, 1>(sm), OutXm{a.xm, hh});
  }
  __syncthreads();   // shared memory is reused by the next item
}

__host__ __device__ inline size_t round16(size_t n) {
  return (n + 15) / 16 * 16;
}

// The launch's dynamic shared memory, byte offsets (16-byte aligned):
// the activation row xs (f32), two unit-sum buffers, the mbarriers and
// the norm's partial sums, the attention region (its stage and aux
// floats; with slot 0 after it, the head's ring once the last attention
// is done), the ring's two slots.
struct Layout {
  size_t red, bars, att, slot0, slot1, bytes;
  __host__ __device__ Layout(int h, int qd, int f, unsigned s0, unsigned s1,
                             int red_floats) {
    const int k = h > qd ? (h > f ? h : f) : (qd > f ? qd : f);
    red = round16(static_cast<size_t>(k) * 4);
    bars = red + round16(2ull * red_floats * 4);
    att = bars + round16(8ull * (2 + kMaxHeadTiles) + 4 * kWarps);
    slot0 = att + round16(AttSmem::bytes + kAuxFloats * sizeof(float));
    slot1 = slot0 + round16(s0);
    bytes = slot1 + round16(s1);
  }
};

__global__ void __launch_bounds__(kThreads)
q8_decode_all_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout lay(a.h, a.qd, a.f, a.slot0, a.slot1, a.red);
  float* xs = reinterpret_cast<float*>(smem_raw);
  float* red = reinterpret_cast<float*>(smem_raw + lay.red);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw + lay.bars);
  uint64_t* full0 = bars;          // slot 0: qkv, gate_up
  uint64_t* full1 = bars + 1;      // slot 1: o, down
  uint64_t* hbar = bars + 2;       // the head ring's tiles
  float* part = reinterpret_cast<float*>(hbar + kMaxHeadTiles);
  unsigned char* att = smem_raw + lay.att;
  unsigned char* slot0 = smem_raw + lay.slot0;
  unsigned char* slot1 = smem_raw + lay.slot1;
  unsigned char* ring = att;       // the head's tiles, after the last
                                   // attention stage
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int h = a.h, qd = a.qd, f = a.f;
  const int nq = qd + 2 * a.kh * kHd;
  // this block's slabs: rows [lo[m], lo[m] + n[m]) (gate_up: pairs)
  int lo[kMats], n[kMats];
#pragma unroll
  for (int m = 0; m < kMats; ++m) {
    const int* row = a.split + m * (gridDim.x + 1) + blockIdx.x;
    lo[m] = __ldg(row);
    n[m] = __ldg(row + 1) - lo[m];
  }
  // the timer: [0] global ns, [1] clock at the start; [2 + 5 l + j] after
  // barrier j of layer l; [2 + 5 L] after the head; [3 + 5 L] global ns
  if (a.stamps && blockIdx.x == 0 && tid == 0) a.stamps[0] = global_ns();
  stamp(a, 1);

  if (tid == 0) {
    bar_init(full0);
    bar_init(full1);
    for (int t = 0; t < a.head_tiles; ++t) bar_init(hbar + t);
    bar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {   // layer 0's first two slabs
    request(slot0, full0, a.qkvq, a.qkvd, h, lo[kQkv], n[kQkv], 0);
    request(slot1, full1, a.oq, a.od, qd, lo[kO], n[kO], 0);
  }
  const Span sp = visible_span(a, reinterpret_cast<int*>(part));
  for (int c = tid; c < h; c += kThreads)
    xs[c] = __bfloat162float(a.nhb0[c]);
  __syncthreads();

  // Slot phases: each slot completes two phases a layer, so qkv and o
  // wait on parity 0, gate_up and down on parity 1. Each request goes out
  // after a grid barrier and after the stage's own reads through L2, not
  // just before a barrier: a burst of copies queued ahead of the
  // barrier's atomics would delay every block's barrier by its drain time.
  for (int l = 0; l < a.L; ++l) {
    const size_t li = l;
    const bool last = l + 1 == a.L;

    // qkv = nh . qkv_w[l]^T
    bar_wait(full0, 0);
    slab_dot(slot0, n[kQkv], h, xs, red);
    __syncthreads();
    for (int r = tid; r < n[kQkv]; r += kThreads)
      a.qkv[lo[kQkv] + r] = row_sum(red, r, units_per_row(h));
    grid.sync();
    stamp(a, 2 + 5 * l);

    // attention items (kv head, chunk of slots) over every block; the
    // last item of each head merges them (no extra grid barrier); slot 0
    // takes the first half of gate_up's slab meanwhile (the second half
    // goes out in the o stage: 7 MB at once would hold up attention's
    // reads through L2 for its whole drain)
    if (tid == 0)
      request_pairs(slot0, full0, a.gq + li * 2 * f * h,
                    a.gd + li * 2 * f * (h >> 5), h, lo[kGateUp], n[kGateUp],
                    f, 0, n[kGateUp] / 2, false);
    for (int it = blockIdx.x; it < a.kh * sp.nch; it += gridDim.x)
      attend_item(a, sp, l, it % a.kh, it / a.kh, att);
    grid.sync();
    stamp(a, 3 + 5 * l);

    // h1 = xm . o[l]^T + res (the embedding row before layer 0); the
    // residual of this thread's row is read before the dot
    {
      const float* add = (l == 0 ? a.x0 : a.res) + lo[kO];
      const float pre = tid < n[kO] ? __ldcg(add + tid) : 0.f;
      load_x(a.xm, qd, xs);
      __syncthreads();
      if (tid == 0)
        request_pairs(slot0, full0, a.gq + li * 2 * f * h,
                      a.gd + li * 2 * f * (h >> 5), h, lo[kGateUp],
                      n[kGateUp], f, n[kGateUp] / 2, n[kGateUp], true);
      bar_wait(full1, 0);
      slab_dot(slot1, n[kO], qd, xs, red);
      __syncthreads();
      for (int r = tid; r < n[kO]; r += kThreads)
        a.h1[lo[kO] + r] = row_sum(red, r, units_per_row(qd))
                           + (r == tid ? pre : __ldcg(add + r));
    }
    grid.sync();
    stamp(a, 4 + 5 * l);

    // act = bf16(silu(nh1 . gate^T) * (nh1 . up^T)); slot 1 takes down's
    // slab meanwhile
    rms_to_xs(a.h1, a.post + li * h, h, a.eps, xs, part);
    if (tid == 0)
      request(slot1, full1, a.dq + li * h * f, a.dd + li * h * (f >> 5), f,
              lo[kDown], n[kDown], 0);
    bar_wait(full0, 1);
    slab_dot(slot0, 2 * n[kGateUp], h, xs, red);
    __syncthreads();
    for (int p = tid; p < n[kGateUp]; p += kThreads) {
      const float g = row_sum(red, p, units_per_row(h));
      const float u = row_sum(red, n[kGateUp] + p, units_per_row(h));
      a.act[lo[kGateUp] + p] = __float2bfloat16(g / (1.f + expf(-g)) * u);
    }
    grid.sync();
    stamp(a, 5 + 5 * l);

    // res = act . down[l]^T + h1; slot 0 takes the next layer's qkv slab
    // meanwhile, or, after the last layer, the head's ring its first tiles
    // (over the attention region and slot 0)
    {
      const float* add = a.h1 + lo[kDown];
      const float pre = tid < n[kDown] ? __ldcg(add + tid) : 0.f;
      load_x(a.act, f, xs);
      __syncthreads();
      if (tid == 0 && !last) {
        request(slot0, full0, a.qkvq + (li + 1) * nq * h,
                a.qkvd + (li + 1) * nq * (h >> 5), h, lo[kQkv], n[kQkv], 0);
      } else if (tid == 0) {
        const unsigned tb = slab_bytes(a.head_rows, h);
        for (int t = 0; t < a.head_tiles; ++t) {
          const int r0 = t * a.head_rows;
          const int rows = min(a.head_rows, n[kHead] - r0);
          if (rows <= 0) break;
          request(ring + t * tb, hbar + t, a.hq, a.hd, h, lo[kHead] + r0,
                  rows, 0);
        }
      }
      bar_wait(full1, 1);
      slab_dot(slot1, n[kDown], f, xs, red);
      __syncthreads();
      for (int r = tid; r < n[kDown]; r += kThreads)
        a.res[lo[kDown] + r] = row_sum(red, r, units_per_row(f))
                               + (r == tid ? pre : __ldcg(add + r));
    }
    grid.sync();
    stamp(a, 6 + 5 * l);

    // the next layer's input norm (after the last layer, the final norm);
    // slot 1 takes the next layer's o slab
    rms_to_xs(a.res, a.nnext + li * h, h, a.eps, xs, part);
    if (tid == 0 && !last)
      request(slot1, full1, a.oq + (li + 1) * h * qd,
              a.od + (li + 1) * h * (qd >> 5), qd, lo[kO], n[kO], 0);
  }

  // logits = nh . head^T: this block's rows in tiles through the ring;
  // the unit sums alternate between two buffers, so one __syncthreads a
  // tile both publishes a tile's sums and frees its slot
  {
    const unsigned tb = slab_bytes(a.head_rows, h);
    const int nc = units_per_row(h);
    const int tiles = (n[kHead] + a.head_rows - 1) / a.head_rows;
    for (int t = 0; t < tiles; ++t) {
      const int s = t % a.head_tiles;
      const int r0 = t * a.head_rows;
      const int rows = min(a.head_rows, n[kHead] - r0);
      float* rb = red + (t & 1) * a.red;
      bar_wait(hbar + s, (t / a.head_tiles) & 1);
      slab_dot(ring + s * tb, rows, h, xs, rb);
      __syncthreads();
      const int next = t + a.head_tiles;
      if (tid == 0 && next < tiles)
        request(ring + s * tb, hbar + s, a.hq, a.hd, h,
                lo[kHead] + next * a.head_rows,
                min(a.head_rows, n[kHead] - next * a.head_rows), 0);
      for (int r = tid; r < rows; r += kThreads)
        a.logits[lo[kHead] + r0 + r] = row_sum(rb, r, nc);
    }
  }
  stamp(a, 2 + 5 * a.L);
  if (a.stamps && blockIdx.x == 0 && tid == 0)
    a.stamps[3 + 5 * a.L] = global_ns();
}

// Co-resident grid size for `smem` bytes of dynamic shared memory on
// device dev, cached per (dev, smem): a decode loop at one shape queries
// once.
cudaError_t grid_blocks(int dev, size_t smem, int* blocks) {
  static std::mutex mu;
  static std::map<std::pair<int, size_t>, int> cache;
  static std::map<int, size_t> smem_attr;            // dev -> opt-in set
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find({dev, smem});
  if (hit != cache.end()) {
    *blocks = hit->second;
    return cudaSuccess;
  }
  int sms = 0, coop = 0, per_sm = 0;
  cudaError_t e =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && smem > 48 * 1024 && smem > smem_attr[dev]) {
    e = cudaFuncSetAttribute(q8_decode_all_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e == cudaSuccess) smem_attr[dev] = smem;
  }
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, q8_decode_all_kernel, kThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *blocks = sms * (per_sm < kMaxBlocksPerSm ? per_sm : kMaxBlocksPerSm);
  cache[{dev, smem}] = *blocks;
  return cudaSuccess;
}

}  // namespace

// x0: f32 [h]; nhb0: bf16 [h]; post, nnext: bf16 [L, h]; qn, kn: bf16
// [L, 128]; cos, sin: f32 [128]; bias: f32 [S]; kc, vc: bf16 [L, kh, S,
// 128]; qkv: int8 [L, nq, h] + f32 [L, nq, h/32] with nq = qd + 2 kh 128;
// o: [L, h, qd]; gate_up: [L, 2f, h]; down: [L, h, f]; head: [vp, h];
// scratch qkv f32 [nq], xm bf16 [qd], res, h1 f32 [h], act bf16 [f];
// logits f32 [vp]; k_new, v_new f32 [L, kh, 128]; att f32 [kh ceil(S /
// 32) 2 130] (the attention items' partials); tickets int32 [kh], zero
// (the kernel leaves them zero); stamps int64 [5 L + 4] (the stage timer)
// or null; split int32 [5][blocks + 1]: the row starts of each block's
// slab of qkv, o, gate_up (in gate / up row pairs), down and the head,
// from 0 to the matrix's rows (pairs); slot0, slot1: bytes of the ring's
// slots, at least the largest slab each holds (qkv, gate_up; o, down;
// slab_bytes); red: floats for one stage's unit sums (R ceil(k / 256) of
// every slab and head tile); head_rows: rows of a head tile. qd = 2 kh
// 128 (GQA group 2), h, qd, f % 128 == 0, 16-byte aligned pointers
// (checked by the wrapper). Returns the launch's cudaError_t: a grid the
// card cannot make co-resident, or shared memory it cannot give, is
// refused, never run partially.
extern "C" int q8_decode_all(
    const void* x0, const void* nhb0, const void* post, const void* nnext,
    const void* qn, const void* kn, const void* cos, const void* sin,
    const void* bias, const void* kc, const void* vc, const void* qkvq,
    const void* qkvd, const void* oq, const void* od, const void* gq,
    const void* gd, const void* dq, const void* dd, const void* hq,
    const void* hd, void* qkv, void* xm, void* res, void* h1, void* act,
    void* logits, void* k_new, void* v_new, void* att, void* tickets,
    void* stamps, const void* split, int L, int h, int qd, int f, int kh,
    int S, int vp, float eps, float scale, int blocks, int slot0, int slot1,
    int red, int head_rows, void* stream) {
  if (L < 1 || S < 1 || kh < 1 || vp < 1 || h % 128 || qd % 128 || f % 128
      || qd != 2 * kh * kHd || blocks < 1 || slot0 < 0 || slot1 < 0
      || red < 1 || head_rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const float*>(x0),
         static_cast<const __nv_bfloat16*>(nhb0),
         static_cast<const __nv_bfloat16*>(post),
         static_cast<const __nv_bfloat16*>(nnext),
         static_cast<const __nv_bfloat16*>(qn),
         static_cast<const __nv_bfloat16*>(kn),
         static_cast<const float*>(cos), static_cast<const float*>(sin),
         static_cast<const float*>(bias),
         static_cast<const __nv_bfloat16*>(kc),
         static_cast<const __nv_bfloat16*>(vc),
         static_cast<const int8_t*>(qkvq), static_cast<const float*>(qkvd),
         static_cast<const int8_t*>(oq), static_cast<const float*>(od),
         static_cast<const int8_t*>(gq), static_cast<const float*>(gd),
         static_cast<const int8_t*>(dq), static_cast<const float*>(dd),
         static_cast<const int8_t*>(hq), static_cast<const float*>(hd),
         static_cast<float*>(qkv), static_cast<__nv_bfloat16*>(xm),
         static_cast<float*>(res), static_cast<float*>(h1),
         static_cast<__nv_bfloat16*>(act), static_cast<float*>(logits),
         static_cast<float*>(k_new), static_cast<float*>(v_new),
         static_cast<float*>(att), static_cast<int*>(tickets),
         L, h, qd, f, kh, S, vp, eps, scale,
         static_cast<long long*>(stamps), static_cast<const int*>(split),
         static_cast<unsigned>(slot0), static_cast<unsigned>(slot1), red,
         head_rows, 0};
  const Layout lay(h, qd, f, a.slot0, a.slot1, red);
  // the head ring: whole tiles over the attention region and slot 0
  a.head_tiles = static_cast<int>((lay.slot1 - lay.att)
                                  / slab_bytes(head_rows, h));
  if (a.head_tiles > kMaxHeadTiles) a.head_tiles = kMaxHeadTiles;
  if (a.head_tiles < 1 || slab_bytes(head_rows, h) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, most = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = grid_blocks(dev, lay.bytes, &most);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (blocks > most) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(q8_decode_all_kernel), dim3(blocks),
      dim3(kThreads), args, lay.bytes, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The co-resident grid of K5 for a launch with the ring's slots of slot0
// and slot1 bytes and red floats of unit sums at widths h, qd, f (blocks,
// out through `blocks`, an int): at most two blocks an SM. The wrapper
// sizes the split from it; the P2 probe's barrier-only launch runs at it
// (csrc/q8_probe.cu). Returns a cudaError_t.
extern "C" int q8_decode_all_grid(int h, int qd, int f, int slot0,
                                  int slot1, int red, void* blocks) {
  if (h < 32 || qd < 32 || f < 32 || slot0 < 0 || slot1 < 0 || red < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = grid_blocks(dev,
                    Layout(h, qd, f, static_cast<unsigned>(slot0),
                           static_cast<unsigned>(slot1), red).bytes,
                    static_cast<int*>(blocks));
  return static_cast<int>(e);
}
