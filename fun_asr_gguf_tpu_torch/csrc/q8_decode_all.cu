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
//     value v_cur; the cached slots: bf16(q).k * scale + bias, p = exp(.-M)
//     summed in f32 and rounded to bf16 for p.v; xm = bf16(acc / l)
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
// shared memory instead of paying another barrier. Attention takes one
// block per kv head (the other blocks wait at the next barrier): the two
// roped query rows sit in shared memory; each thread scores its own cache
// slots (a whole K row against both rows), the scores of the row live in
// shared memory (8 bytes per slot), then an exact softmax over the row
// with the current token's f32 term, then warps take slots in turn with
// lanes owning 4 head_dim columns for p.v. A slot whose bias is -1e29 or
// below (the callers' -1e30 mask) contributes exp(-1e30 - M) = 0 to both
// sums, so it is skipped without reading its K or V row: the cache bytes a
// step reads are those of its visible slots.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

#include "q8_gemv.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace q8;

constexpr int kHd = 128;               // head_dim: 32 lanes x 4 columns
constexpr int kMaxBlocksPerSm = 2;     // fewer blocks, cheaper grid barriers
constexpr float kMasked = -1e29f;      // bias at or below: a masked slot
static_assert(kThreads == 2 * kHd, "the p.v epilogue maps a thread to one "
                                   "(query row, column) pair");

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
  int L, h, qd, f, kh, S, vp;
  float eps, scale;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Block-wide max / sum of one value per thread (kThreads threads); red
// holds kWarps floats of shared memory.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  __syncthreads();                      // red may still be read
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// Attention of query heads 2hh, 2hh+1 of layer l over kv head hh; writes
// xm[(2hh+g)*D + d], k_new / v_new[l, hh]. sm: the block's attention
// shared memory (see attn_floats).
__device__ void attend_head(const Args& a, int l, int hh, float* sm) {
  constexpr int D = kHd;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int S = a.S;
  float* qf = sm;                  // [2][D] roped q, f32
  float* qb = qf + 2 * D;          // [2][D] the same rounded to bf16
  float* vcur = qb + 2 * D;        // [D]
  float* red = vcur + D;           // [kWarps][2][D] p.v partials
  float* st = red + kWarps * 2 * D;  // [16]: s_cur[2], reductions
  float* sc = st + 16;             // [2][S] scores, then probabilities
  const size_t row = static_cast<size_t>(l) * a.kh + hh;
  const int nq_k = a.qd + hh * D, nq_v = a.qd + (a.kh + hh) * D;

  // phase 0: qk-norm + rope of q rows (warps 0, 1) and k (warp 2), the v
  // row (warp 3); each lane owns columns 4*lane..4*lane+3, and the rope
  // partner (column d +- 64) sits in lane ^ 16
  float kcur[4];
  if (warp < 3) {
    const int off = warp < 2 ? (2 * hh + warp) * D : nq_k;
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
      const float y = x[i] * __ldg(a.cos + d)
                      + (lane < 16 ? -p : p) * __ldg(a.sin + d);
      if (warp < 2) {
        qf[warp * D + d] = y;
        qb[warp * D + d] = bf16_round(y);
      } else {
        kcur[i] = y;
        a.k_new[row * D + d] = y;
      }
    }
  } else if (warp == 3) {
    const float4 v4 = __ldcg(reinterpret_cast<const float4*>(
        a.qkv + nq_v + 4 * lane));
    const float x[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      vcur[4 * lane + i] = x[i];
      a.v_new[row * D + 4 * lane + i] = x[i];
    }
  }
  __syncthreads();
  if (warp == 2) {   // the current token's scores, in f32
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) s += qf[g * D + 4 * lane + i] * kcur[i];
      s = warp_sum(s);
      if (lane == 0) st[g] = s * a.scale;
    }
  }

  // phase 1: each thread scores its own slots against both rows
  const __nv_bfloat16* kbase = a.kc + row * S * D;
  const __nv_bfloat16* vbase = a.vc + row * S * D;
  float m0 = -INFINITY, m1 = -INFINITY;
  for (int s = tid; s < S; s += kThreads) {
    const float b = __ldg(a.bias + s);
    float s0 = -INFINITY, s1 = -INFINITY;
    if (b > kMasked) {
      const __nv_bfloat16* kr = kbase + static_cast<size_t>(s) * D;
      float d0 = 0.f, d1 = 0.f;
#pragma unroll 4
      for (int c = 0; c < D; c += 8) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(kr + c));
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float kv = __bfloat162float(e[i]);
          d0 = fmaf(qb[c + i], kv, d0);
          d1 = fmaf(qb[D + c + i], kv, d1);
        }
      }
      s0 = d0 * a.scale + b;
      s1 = d1 * a.scale + b;
    }
    sc[s] = s0;
    sc[S + s] = s1;
    m0 = fmaxf(m0, s0);
    m1 = fmaxf(m1, s1);
  }
  __syncthreads();   // st[0..1] from warp 2

  // phase 2: exact softmax over the row, the current token included
  const float c0 = st[0], c1 = st[1];
  const float mx0 = fmaxf(c0, block_reduce<true>(m0, st + 4));
  const float mx1 = fmaxf(c1, block_reduce<true>(m1, st + 4));
  float l0 = 0.f, l1 = 0.f;
  for (int s = tid; s < S; s += kThreads) {
    const float p0 = expf(sc[s] - mx0), p1 = expf(sc[S + s] - mx1);
    sc[s] = p0;
    sc[S + s] = p1;
    l0 += p0;
    l1 += p1;
  }
  const float pc0 = expf(c0 - mx0), pc1 = expf(c1 - mx1);
  l0 = block_reduce<false>(l0, st + 4) + pc0;
  l1 = block_reduce<false>(l1, st + 4) + pc1;
  __syncthreads();   // every probability written

  // phase 3: p.v, warps take slots in turn, lanes own 4 columns
  float acc0[4] = {}, acc1[4] = {};
  for (int s = warp; s < S; s += kWarps) {
    const float p0 = sc[s], p1 = sc[S + s];
    if (p0 == 0.f && p1 == 0.f) continue;   // masked: adds nothing
    const float b0 = bf16_round(p0), b1 = bf16_round(p1);
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(
        vbase + static_cast<size_t>(s) * D + 4 * lane));
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float vv = __bfloat162float(e[i]);
      acc0[i] = fmaf(b0, vv, acc0[i]);
      acc1[i] = fmaf(b1, vv, acc1[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    red[(warp * 2) * D + 4 * lane + i] = acc0[i];
    red[(warp * 2 + 1) * D + 4 * lane + i] = acc1[i];
  }
  __syncthreads();
  {
    const int g = tid / D, d = tid % D;
    float o = vcur[d] * (g ? pc1 : pc0);
    for (int w = 0; w < kWarps; ++w) o += red[(w * 2 + g) * D + d];
    a.xm[(2 * hh + g) * D + d] = __float2bfloat16(o / (g ? l1 : l0));
  }
  __syncthreads();   // shared memory is reused by the next head
}

// floats of attention shared memory for S cache slots (attend_head)
__host__ __device__ inline size_t attn_floats(int S) {
  return 5 * kHd + kWarps * 2 * kHd + 16 + 2 * static_cast<size_t>(S);
}

__host__ __device__ inline size_t nh_bytes(int h) {
  return (static_cast<size_t>(h) * 2 + 15) / 16 * 16;
}

__global__ void __launch_bounds__(kThreads)
q8_decode_all_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* nh = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [h]
  float* att = reinterpret_cast<float*>(smem_raw + nh_bytes(a.h));
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int nwarps = gridDim.x * kWarps;
  const int h = a.h, qd = a.qd, f = a.f;
  const int nq = qd + 2 * a.kh * kHd;

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

    for (int hh = blockIdx.x; hh < a.kh; hh += gridDim.x)
      attend_head(a, l, hh, att);
    grid.sync();

    // h1 = xm . o[l]^T + res (the embedding row before layer 0)
    gemv_rows<1, Src::kL2>(a.oq + li * h * qd, a.od + li * h * (qd >> 5), a.xm,
                           1, qd, h, l == 0 ? a.x0 : a.res, a.h1, h, gwarp,
                           nwarps, lane);
    grid.sync();

    rms_rows_to_smem(a.h1, a.post + li * h, 1, h, a.eps, nh);
    __syncthreads();
    gate_up_rows<1>(a.gq + li * 2 * f * h, a.gd + li * 2 * f * (h >> 5), nh, 1,
                    h, f, a.act, gwarp, nwarps, lane);
    grid.sync();

    // res = act . down[l]^T + h1
    gemv_rows<1, Src::kL2>(a.dq + li * h * f, a.dd + li * h * (f >> 5), a.act,
                           1, f, h, a.h1, a.res, h, gwarp, nwarps, lane);
    grid.sync();

    // the next layer's input norm; after the last layer, the final norm
    rms_rows_to_smem(a.res, a.nnext + li * h, 1, h, a.eps, nh);
    __syncthreads();
  }

  gemv_rows<1, Src::kShared>(a.hq, a.hd, nh, 1, h, a.vp, nullptr, a.logits,
                             a.vp, gwarp, nwarps, lane);
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
// logits f32 [vp]; k_new, v_new f32 [L, kh, 128]. qd = 2 kh 128 (GQA
// group 2), h, qd, f % 32 == 0, 16-byte aligned pointers (checked by the
// wrapper). Returns the launch's cudaError_t: a grid the card cannot make
// co-resident, or shared memory it cannot give, is refused, never run
// partially.
extern "C" int q8_decode_all(
    const void* x0, const void* nhb0, const void* post, const void* nnext,
    const void* qn, const void* kn, const void* cos, const void* sin,
    const void* bias, const void* kc, const void* vc, const void* qkvq,
    const void* qkvd, const void* oq, const void* od, const void* gq,
    const void* gd, const void* dq, const void* dd, const void* hq,
    const void* hd, void* qkv, void* xm, void* res, void* h1, void* act,
    void* logits, void* k_new, void* v_new, int L, int h, int qd, int f,
    int kh, int S, int vp, float eps, float scale, void* stream) {
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
         L, h, qd, f, kh, S, vp, eps, scale};
  const size_t smem = nh_bytes(h) + attn_floats(S) * sizeof(float);
  int dev = 0, blocks = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = grid_blocks(dev, smem, &blocks);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(q8_decode_all_kernel), dim3(blocks),
      dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
