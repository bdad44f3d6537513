// K7 — the int8-dot q8_0 layer chain for Hopper (sm_90a), one cooperative
// launch per layer.
//
//   h1  = q8(attn) . o^T + resid                                  (f32)
//   act = silu(q8(rms(h1) * post_w) . gate^T) * (... . up^T)      (f32)
//   out = q8(act) . down^T + h1                                   (f32, output)
//   qkv = q8(rms(out) * next_w) . next_qkv^T                      (f32, optional)
//
// where q8(.) is the q8_0 quantization of an f32 row per 32-block and every
// product is K6's s8 x s8 block dot with both scales on the partial
// (q8_dot.cuh). Replaces the Pallas kernels of
// fun_asr_gguf_tpu/ops/quant_matmul.py q8i_layer_fused (:1586; pallas_call
// :1650 with the next-layer qkv, :1667 without; body _q8i_layer_body
// :1516). Numerics follow JAX's reference _q8i_layer_ref (:1550): every
// intermediate (h1, the normed rows, gate_up, act, out, qkv) is f32, only
// the int8 quantization rounds; nothing is rounded to bf16 (unlike K4). The
// attention output arrives already quantized (the caller's
// quantize_act_q8), as in JAX.
//
// What bounds it: bytes. One call at Qwen3-0.6B width reads 15.73 MB of
// int8 plus 1.97 MB of f32 scales (o 1024x2048, gate_up 6144x1024, down
// 1024x3072, next qkv 4096x1024): a 5.3 us floor at the H100's 3.35 TB/s,
// the same weights as K4.
//
// Design. K4's shape (q8_layer_fused.cu): every stage needs the whole
// previous row (the RMSNorm needs all of h1, down needs all of act), and
// blocks run in parallel in no order, so the chain is ONE cooperative
// launch sized to co-residency with grid barriers between the stages:
//   o + residual | norm + quantize + gate_up + gate | quantize + down +
//   residual | norm + quantize + next qkv
// The f32 rows h1 and act live in scratch the wrapper allocates. After a
// barrier every block rebuilds the q8_0 activation rows it needs in its own
// shared memory (int8 values and block scales, m * 3072 + m * 384 bytes at
// most): cheaper than another barrier. The products are K6's GEMV, one
// warp per output row for all m rows; the warp that takes gate row j also
// takes up row j + f, so silu(g) * u is formed in registers. The RMSNorm's
// 1/sqrt is rsqrtf, which may differ from the CPU's by an ulp and so flip
// an isolated int8 value at a .5 boundary downstream.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "q8_dot.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace q8dot;

constexpr int kMaxBlocksPerSm = 2;   // fewer blocks, cheaper grid barriers
constexpr int kMaxRows = 16;
constexpr size_t kRowScaleBytes = kMaxRows * sizeof(float);

struct Args {
  const int8_t* aq;       // [m, qd]   the attention output in q8_0
  const float* as;        // [m, qd/32]
  const float* resid;     // [m, h]
  const __nv_bfloat16* post_w;   // [h]
  const __nv_bfloat16* next_w;   // [h]   (null without the qkv stage)
  const int8_t* oq;       // [h, qd]
  const float* od;        // [h, qd/32]
  const int8_t* gq;       // [2f, h]   gate rows, then up rows
  const float* gd;
  const int8_t* dq;       // [h, f]
  const float* dd;
  const int8_t* qq;       // [nq, h]   (null without the qkv stage)
  const float* qs;
  float* h1;              // scratch [m, h]
  float* act;             // scratch [m, f]
  float* out;             // [m, h]
  float* qkv;             // [m, nq]
  int m, qd, h, f, nq, kmax;
  float eps;
};

__host__ __device__ constexpr size_t smem_bytes(int m, int kmax) {
  return kRowScaleBytes + static_cast<size_t>(m) * kmax +
         static_cast<size_t>(m) * (kmax / 32) * 4;
}

// y[r * ld + j] = q8 rows . w_j (+ add[r * ld + j], read via L2) for every
// output row j < n this warp takes, all m rows.
template <int MT>
__device__ __forceinline__ void gemv_rows(const int8_t* wq, const float* wd,
                                          const int8_t* xq, const float* xs,
                                          int m, int k, int n,
                                          const float* add, float* y, int ld,
                                          int gwarp, int nwarps, int lane) {
  for (int j = gwarp; j < n; j += nwarps) {
    const int8_t* const q[1] = {wq + static_cast<size_t>(j) * k};
    const float* const d[1] = {wd + static_cast<size_t>(j) * (k >> 5)};
    float acc[1][MT] = {};
    dot_rows<MT, 1>(q, d, xq, xs, m, k, lane, acc);
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      if (r < m) {
        const float v = warp_sum(acc[0][r]);
        if (lane == 0) {
          const size_t i = static_cast<size_t>(r) * ld + j;
          y[i] = add ? v + __ldcg(add + i) : v;
        }
      }
    }
  }
}

// xq / xs = q8((x[r, :] * rs[r]) * w) for r < m over a row of h, after the
// row scales: the normed row of JAX's _rms_col, then its quantization.
__device__ __forceinline__ void norm_quant_rows(const float* x,
                                                const __nv_bfloat16* w,
                                                int m, int h, float eps,
                                                float* rs, int8_t* xq,
                                                float* xs) {
  rms_scales(x, m, h, eps, rs);
  __syncthreads();
  quant_rows_to_smem(
      [&](int r, int c) {
        const float v = __ldcg(x + static_cast<size_t>(r) * h + c);
        return __fmul_rn(__fmul_rn(v, rs[r]), __bfloat162float(w[c]));
      },
      m, h, xq, xs);
  __syncthreads();
}

template <int MT>
__global__ void __launch_bounds__(kThreads)
q8i_layer_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* rs = reinterpret_cast<float*>(smem_raw);                 // [16]
  int8_t* xq = reinterpret_cast<int8_t*>(smem_raw + kRowScaleBytes);
  float* xs = reinterpret_cast<float*>(smem_raw + kRowScaleBytes +
                                       static_cast<size_t>(a.m) * a.kmax);
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int nwarps = gridDim.x * kWarps;
  const int m = a.m, h = a.h, f = a.f;

  // stage 1: h1 = q8(attn) . o^T + resid; the q8_0 rows are an input
  for (int i = threadIdx.x; i < m * a.qd / 16; i += kThreads)
    reinterpret_cast<int4*>(xq)[i] =
        __ldg(reinterpret_cast<const int4*>(a.aq) + i);
  for (int i = threadIdx.x; i < m * (a.qd >> 5); i += kThreads)
    xs[i] = __ldg(a.as + i);
  __syncthreads();
  gemv_rows<MT>(a.oq, a.od, xq, xs, m, a.qd, h, a.resid, a.h1, h, gwarp,
                nwarps, lane);
  grid.sync();

  // stage 2: act = silu(q8(nh) . gate^T) * (q8(nh) . up^T), nh from h1
  norm_quant_rows(a.h1, a.post_w, m, h, a.eps, rs, xq, xs);
  for (int j = gwarp; j < f; j += nwarps) {
    const int8_t* const q[2] = {a.gq + static_cast<size_t>(j) * h,
                                a.gq + static_cast<size_t>(j + f) * h};
    const float* const d[2] = {a.gd + static_cast<size_t>(j) * (h >> 5),
                               a.gd + static_cast<size_t>(j + f) * (h >> 5)};
    float acc[2][MT] = {};
    dot_rows<MT, 2>(q, d, xq, xs, m, h, lane, acc);
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      if (r < m) {
        const float g = warp_sum(acc[0][r]);
        const float u = warp_sum(acc[1][r]);
        if (lane == 0)
          a.act[static_cast<size_t>(r) * f + j] = g / (1.f + expf(-g)) * u;
      }
    }
  }
  grid.sync();

  // stage 3: out = q8(act) . down^T + h1
  quant_rows_to_smem(
      [&](int r, int c) {
        return __ldcg(a.act + static_cast<size_t>(r) * f + c);
      },
      m, f, xq, xs);
  __syncthreads();
  gemv_rows<MT>(a.dq, a.dd, xq, xs, m, f, h, a.h1, a.out, h, gwarp, nwarps,
                lane);
  if (a.qq == nullptr) return;   // uniform over the grid: no barrier skipped
  grid.sync();

  // stage 4: qkv = q8(nh2) . next_qkv^T, nh2 the next layer's input norm
  norm_quant_rows(a.out, a.next_w, m, h, a.eps, rs, xq, xs);
  gemv_rows<MT>(a.qq, a.qs, xq, xs, m, h, a.nq, nullptr, a.qkv, a.nq, gwarp,
                nwarps, lane);
}

template <int MT>
cudaError_t launch(Args& a, cudaStream_t stream) {
  int dev = 0, coop = 0, blocks = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  // sized for the largest m this instance serves, so that the shared
  // memory of any m <= MT fits the co-residency the query reported
  if (e == cudaSuccess)
    e = grid_blocks(q8i_layer_kernel<MT>, dev, a.kmax,
                    smem_bytes(MT, a.kmax), kMaxBlocksPerSm, &blocks);
  if (e != cudaSuccess) return e;
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(q8i_layer_kernel<MT>), dim3(blocks),
      dim3(kThreads), args, smem_bytes(a.m, a.kmax), stream);
}

}  // namespace

// aq: int8 [m, qd] + as: f32 [m, qd/32] (the attention output in q8_0);
// resid: f32 [m, h]; post_w, next_w: bf16 [h];
// o: int8 [h, qd] + f32 [h, qd/32]; gate_up: [2f, h]; down: [h, f]; next
// qkv: [nq, h] (qq == null: no qkv stage, next_w and qkv unused); scratch
// h1: f32 [m, h], act: f32 [m, f]; out: f32 [m, h]; qkv: f32 [m, nq].
// 1 <= m <= 16, qd, h, f % 32 == 0, 16-byte aligned pointers (checked by
// the wrapper). Returns the launch's cudaError_t: a grid the card cannot
// make co-resident is refused, never run partially.
extern "C" int q8i_layer_fused(const void* aq, const void* as,
                               const void* resid, const void* post_w,
                               const void* next_w, const void* oq,
                               const void* od, const void* gq, const void* gd,
                               const void* dq, const void* dd, const void* qq,
                               const void* qs, void* h1, void* act, void* out,
                               void* qkv, int m, int qd, int h, int f, int nq,
                               float eps, void* stream) {
  int kmax = qd > h ? qd : h;
  kmax = kmax > f ? kmax : f;
  if (m < 1 || m > kMaxRows || qd < 32 || h < 32 || f < 32 || qd % 32 ||
      h % 32 || f % 32 || smem_bytes(kMaxRows, kmax) > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const int8_t*>(aq), static_cast<const float*>(as),
         static_cast<const float*>(resid),
         static_cast<const __nv_bfloat16*>(post_w),
         static_cast<const __nv_bfloat16*>(next_w),
         static_cast<const int8_t*>(oq), static_cast<const float*>(od),
         static_cast<const int8_t*>(gq), static_cast<const float*>(gd),
         static_cast<const int8_t*>(dq), static_cast<const float*>(dd),
         static_cast<const int8_t*>(qq), static_cast<const float*>(qs),
         static_cast<float*>(h1), static_cast<float*>(act),
         static_cast<float*>(out), static_cast<float*>(qkv),
         m, qd, h, f, nq, kmax, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (m == 1) e = launch<1>(a, s);
  else if (m <= 4) e = launch<4>(a, s);
  else e = launch<16>(a, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
