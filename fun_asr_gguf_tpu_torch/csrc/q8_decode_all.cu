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
// Design. One launch sized to co-residency, with a grid-wide barrier
// between stages that need a whole previous row: qkv | attention | o |
// norm + gate_up | down, five per layer (140 at 28 layers) — the first
// thing that holds the step above its byte floor. The GEMVs are K4's (one
// warp per output row, 16-byte int8 loads, q8_gemv.cuh); after a barrier
// each block recomputes the 1024-wide RMSNorm of the f32 row into its own
// shared memory instead of paying another barrier. Attention is split-KV
// over every block (split_kv.cuh, the stage K2 runs): the work items are
// (kv head, chunk of cache slots), sized so that the heads' chunks about
// fill the grid; each block recomputes the two roped query rows of its
// head, stages its chunk's K and V tiles with cp.async, scores and mixes
// them with mma.sync (probabilities rounded to bf16 unnormalised, as JAX's
// chunked stage does, quant_matmul.py :1870-1880) and writes the chunk's
// (m, l, acc); the last block of a head (an atomic ticket, no extra grid
// barrier) merges the chunks in order, started from the current token's
// f32 term (m = s_cur, l = 1, acc = v_cur), into xm. A tile whose bias is
// -1e29 or below for every slot (the callers' -1e30 mask) is skipped
// without reading its K or V rows: the cache bytes a step reads are those
// of its visible tiles. The shared memory does not grow with S.
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
#include "split_kv.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace q8;

constexpr int kHd = 128;               // head_dim: 32 lanes x 4 columns
constexpr int kMaxBlocksPerSm = 2;     // fewer blocks, cheaper grid barriers
static_assert(kWarps >= 4, "warps 0..3 form the current token's rows");

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
  int chunk, nch;                // cache slots per attention item, items
                                 // per kv head
  long long* stamps;             // the stage timer [5 L + 4], or null
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
__device__ void attend_item(const Args& a, int l, int hh, int c,
                            unsigned char* sm) {
  constexpr int D = kHd;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* aux = reinterpret_cast<float*>(sm + AttSmem::bytes);
  float* qf = aux;                 // [2][D]
  float* kcur = qf + 2 * D;        // [D]
  float* vcur = kcur + D;          // [D]
  float* scur = vcur + D;          // [2]
  const size_t row = static_cast<size_t>(l) * a.kh + hh;

  // the two roped query rows: f32 (the current token's score) and bf16
  // (the cached slots' scores); stage rows 2..15 are padding
  if (warp < 2) {
    float y[4];
    rope_row(a, l, hh, warp, y);
    __nv_bfloat16* qb = skv::q_rows(sm) + warp * AttSmem::kQStride;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qf[warp * D + 4 * lane + i] = y[i];
      qb[4 * lane + i] = __float2bfloat16(y[i]);
    }
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
  const int nch = a.nch;
  // att: acc [kh][nch][2][D], then m [kh][nch][2], then l
  float* pacc = a.att + hh * nch * 2 * D;
  float* pm = a.att + a.kh * nch * 2 * D + hh * nch * 2;
  float* pl = pm + a.kh * nch * 2;
  const int s0 = c * a.chunk, s1 = min(a.S, s0 + a.chunk);
  skv::stage<__nv_bfloat16, 1, kWarps>(in, s0, s1, sm, pm + c * 2,
                                       pl + c * 2, pacc + c * 2 * D);
  if (skv::last_block(a.tickets + hh, nch,
                      reinterpret_cast<int*>(sm + AttSmem::flag))) {
    // the current token: its roped k (warp 2) and v (warp 3), in f32
    if (warp == 2) {
      float y[4];
      rope_row(a, l, hh, 2, y);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kcur[4 * lane + i] = y[i];
        a.k_new[row * D + 4 * lane + i] = y[i];
      }
    } else if (warp == 3) {
      const float4 v4 = __ldcg(reinterpret_cast<const float4*>(
          a.qkv + a.qd + (a.kh + hh) * D + 4 * lane));
      const float x[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        vcur[4 * lane + i] = x[i];
        a.v_new[row * D + 4 * lane + i] = x[i];
      }
    }
    __syncthreads();
    if (warp < 2) {   // s_cur of query row g = warp, in f32
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

__host__ __device__ inline size_t nh_bytes(int h) {
  return (static_cast<size_t>(h) * 2 + 15) / 16 * 16;
}

// the launch's dynamic shared memory: the attention stage's does not grow
// with S
inline size_t step_smem(int h) {
  return nh_bytes(h) + AttSmem::bytes + kAuxFloats * sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
q8_decode_all_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* nh = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [h]
  unsigned char* att = smem_raw + nh_bytes(a.h);
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int nwarps = gridDim.x * kWarps;
  const int h = a.h, qd = a.qd, f = a.f;
  const int nq = qd + 2 * a.kh * kHd;
  // the timer: [0] global ns, [1] clock at the start; [2 + 5 l + j] after
  // barrier j of layer l; [2 + 5 L] after the head; [3 + 5 L] global ns
  if (a.stamps && blockIdx.x == 0 && threadIdx.x == 0)
    a.stamps[0] = global_ns();
  stamp(a, 1);

  for (int c = threadIdx.x * 8; c < h; c += kThreads * 8)
    *reinterpret_cast<uint4*>(nh + c) =
        __ldg(reinterpret_cast<const uint4*>(a.nhb0 + c));
  __syncthreads();

  for (int l = 0; l < a.L; ++l) {
    const size_t li = l;
    // qkv = nh . qkv_w[l]^T
    gemv_rows<1, Src::kShared>(a.qkvq + li * nq * h, a.qkvd + li * nq * (h >> 5),
                               nh, 1, h, nq, nullptr, a.qkv, nq, gwarp,
                               nwarps, lane);
    grid.sync();
    stamp(a, 2 + 5 * l);

    // attention items (kv head, chunk of slots) over every block; the
    // last item of each head merges them (no extra grid barrier)
    for (int it = blockIdx.x; it < a.kh * a.nch; it += gridDim.x)
      attend_item(a, l, it % a.kh, it / a.kh, att);
    grid.sync();
    stamp(a, 3 + 5 * l);

    // h1 = xm . o[l]^T + res (the embedding row before layer 0)
    gemv_rows<1, Src::kL2>(a.oq + li * h * qd, a.od + li * h * (qd >> 5), a.xm,
                           1, qd, h, l == 0 ? a.x0 : a.res, a.h1, h, gwarp,
                           nwarps, lane);
    grid.sync();
    stamp(a, 4 + 5 * l);

    rms_rows_to_smem(a.h1, a.post + li * h, 1, h, a.eps, nh);
    __syncthreads();
    gate_up_rows<1>(a.gq + li * 2 * f * h, a.gd + li * 2 * f * (h >> 5), nh, 1,
                    h, f, a.act, gwarp, nwarps, lane);
    grid.sync();
    stamp(a, 5 + 5 * l);

    // res = act . down[l]^T + h1
    gemv_rows<1, Src::kL2>(a.dq + li * h * f, a.dd + li * h * (f >> 5), a.act,
                           1, f, h, a.h1, a.res, h, gwarp, nwarps, lane);
    grid.sync();
    stamp(a, 6 + 5 * l);

    // the next layer's input norm; after the last layer, the final norm
    rms_rows_to_smem(a.res, a.nnext + li * h, 1, h, a.eps, nh);
    __syncthreads();
  }

  gemv_rows<1, Src::kShared>(a.hq, a.hd, nh, 1, h, a.vp, nullptr, a.logits,
                             a.vp, gwarp, nwarps, lane);
  stamp(a, 2 + 5 * a.L);
  if (a.stamps && blockIdx.x == 0 && threadIdx.x == 0)
    a.stamps[3 + 5 * a.L] = global_ns();
}

// Co-resident grid size for `smem` bytes of dynamic shared memory on
// device dev, cached per (dev, smem): a decode loop at one S queries once.
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
// or null. qd = 2 kh 128 (GQA group 2), h, qd, f % 32 == 0, 16-byte
// aligned pointers (checked by the wrapper). Returns the launch's
// cudaError_t: a grid the card cannot make
// co-resident, or shared memory it cannot give, is refused, never run
// partially.
extern "C" int q8_decode_all(
    const void* x0, const void* nhb0, const void* post, const void* nnext,
    const void* qn, const void* kn, const void* cos, const void* sin,
    const void* bias, const void* kc, const void* vc, const void* qkvq,
    const void* qkvd, const void* oq, const void* od, const void* gq,
    const void* gd, const void* dq, const void* dd, const void* hq,
    const void* hd, void* qkv, void* xm, void* res, void* h1, void* act,
    void* logits, void* k_new, void* v_new, void* att, void* tickets,
    void* stamps, int L, int h, int qd, int f, int kh, int S, int vp,
    float eps, float scale, void* stream) {
  if (L < 1 || S < 1 || kh < 1 || vp < 1 || h % 32 || qd % 32 || f % 32
      || qd != 2 * kh * kHd)
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
         L, h, qd, f, kh, S, vp, eps, scale, 0, 0,
         static_cast<long long*>(stamps)};
  const size_t smem = step_smem(h);
  int dev = 0, blocks = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = grid_blocks(dev, smem, &blocks);
  if (e != cudaSuccess) return static_cast<int>(e);
  // one attention item per block: kv heads x chunks ~ the grid
  a.chunk = skv::chunk_slots(S, kh, blocks);
  a.nch = (S + a.chunk - 1) / a.chunk;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(q8_decode_all_kernel), dim3(blocks),
      dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The co-resident grid K5 launches at width h (blocks, out through
// `blocks`, an int): the P2 probe's barrier-only launch at K5's grid
// (csrc/q8_probe.cu). Returns a cudaError_t.
extern "C" int q8_decode_all_grid(int h, void* blocks) {
  if (h < 32 || h % 32) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = grid_blocks(dev, step_smem(h), static_cast<int*>(blocks));
  return static_cast<int>(e);
}
