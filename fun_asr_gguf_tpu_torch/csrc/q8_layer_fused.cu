// K4 — fused per-layer q8_0 chain for Hopper (sm_90a), one cooperative launch.
//
//   h1  = xm . o^T + resid                                   (f32)
//   nh  = bf16(rmsnorm(h1) * post_w)
//   act = bf16(silu(nh . gate^T) * (nh . up^T))              (gate_up packed)
//   out = act . down^T + h1                                  (f32, output)
//   qkv = bf16(rmsnorm(out) * next_w) . next_qkv^T           (f32, optional)
//
// Replaces the Pallas kernels fun_asr_gguf_tpu/ops/quant_matmul.py
// q8_mlp_qkv_fused (:832; grid=(1,) body _q8_mlp_qkv_fused_body :770, staged
// form _q8_mega_staged_call :1183) and q8_mlp_fused (:649, the same chain
// without the next-layer stage), and — with the final norm in next_w and
// the 152576-row q8_0 lm_head in the qkv slot, so that qkv is the logits —
// q8_layer_head_fused (:953, K4c). Numerics follow the JAX reference path
// (_q8_mlp_fused_ref :623, _q8_mlp_qkv_fused_ref :814): every q*d is formed
// in f32 and rounded to bf16 once (the Pallas bodies' bf16 rounding of d is
// not copied); activations entering a product are bf16; sums accumulate in
// f32; both RMSNorms (mean over the whole row) and both residual adds are
// in f32. Weights stay in natural GGUF order: the TPU's perm space does not
// exist here.
//
// What bounds it: bytes. One call at Qwen3-0.6B width reads 15.73 MB of
// int8 plus 1.97 MB of f32 scales (o 1024x2048, gate_up 6144x1024, down
// 1024x3072, next qkv 4096x1024); at m <= 16 activation rows the chain is
// four GEMVs, whose floor is 5.3 us at the H100's 3.35 TB/s. As K4c the
// last stage streams the head instead (152576x1024 int8 + f32 scales,
// 175.77 MB): 11.54 + 1.44 MB of layer weights plus the head, a 0.056 ms
// floor at m = 1. Every row offset is taken in size_t, so the head's
// 156 M-element rows and the [m, 152576] logits index without overflow.
//
// Design. Every stage needs the whole previous row (the RMSNorm needs all
// 1024 outputs of o, down needs all 3072 gated values), and blocks run in
// parallel in no order, so the chain is ONE cooperative launch sized to
// co-residency with grid-wide barriers between the stages:
//   o + residual | norm + gate_up + gate | down + residual | norm + next qkv
// Row intermediates live in scratch the wrapper allocates (h1 [m, h] f32,
// act [m, f] bf16). After a barrier every block recomputes the 1024-wide
// RMSNorm of the f32 row into its own shared memory: cheaper than another
// barrier. The GEMV is K1's: one warp per output row for all m activation
// rows, 16-byte int8 loads (half a q8_0 block, one scale each); the warp
// that takes gate row j also takes up row j + f, so silu(g) * u is formed
// in registers. Data written inside the launch is read with ld.global.cg
// (L2), never through the read-only path. The GEMV, the row RMSNorm and
// the loads live in q8_gemv.cuh, shared with K5 (q8_decode_all.cu).

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

constexpr int kMaxBlocksPerSm = 2;   // fewer blocks, cheaper grid barriers

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
  int m, qd, h, f, nq;
  float eps;
};

template <int MT>
__global__ void __launch_bounds__(kThreads)
q8_layer_fused_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* nh = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [m, h]
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int nwarps = gridDim.x * kWarps;
  const int m = a.m, h = a.h, f = a.f;

  // stage 1: h1 = xm . o^T + resid
  for (int j = gwarp; j < h; j += nwarps) {
    const int8_t* const q[1] = {a.oq + static_cast<size_t>(j) * a.qd};
    const float* const d[1] = {a.od + static_cast<size_t>(j) * (a.qd >> 5)};
    float acc[1][MT] = {};
    rows_dot<MT, 1, Src::kReadOnly>(q, d, a.xm, m, a.qd, lane, acc);
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      if (r < m) {
        const float v = warp_sum(acc[0][r]);
        if (lane == 0) {
          const size_t i = static_cast<size_t>(r) * h + j;
          a.h1[i] = v + __bfloat162float(a.resid[i]);
        }
      }
    }
  }
  grid.sync();

  // stage 2: act = bf16(silu(nh . gate^T) * (nh . up^T)), nh from h1
  rms_rows_to_smem(a.h1, a.post_w, m, h, a.eps, nh);
  __syncthreads();
  gate_up_rows<MT>(a.gq, a.gd, nh, m, h, f, a.act, gwarp, nwarps, lane);
  grid.sync();

  // stage 3: out = act . down^T + h1
  gemv_rows<MT, Src::kL2>(a.dq, a.dd, a.act, m, f, h, a.h1, a.out, h, gwarp,
                          nwarps, lane);
  if (a.qq == nullptr) return;   // uniform over the grid: no barrier skipped
  grid.sync();

  // stage 4: qkv = nh2 . next_qkv^T, nh2 = the next layer's input norm of out
  rms_rows_to_smem(a.out, a.next_w, m, h, a.eps, nh);
  __syncthreads();
  gemv_rows<MT, Src::kShared>(a.qq, a.qs, nh, m, h, a.nq, nullptr, a.qkv,
                              a.nq, gwarp, nwarps, lane);
}

// Co-resident grid size of q8_layer_fused_kernel<MT> for row width h on
// device dev: the attribute and occupancy queries run once per (dev, h)
// and are cached, so a decode step's 28 launches make none of them.
template <int MT>
cudaError_t grid_blocks(int dev, int h, int* blocks) {
  static std::mutex mu;
  static std::map<std::pair<int, int>, int> cache;   // (dev, h) -> blocks
  static std::map<int, size_t> smem_attr;            // dev -> smem opt-in set
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find({dev, h});
  if (hit != cache.end()) {
    *blocks = hit->second;
    return cudaSuccess;
  }
  auto kernel = q8_layer_fused_kernel<MT>;
  int sms = 0, coop = 0, per_sm = 0;
  cudaError_t e =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // size the grid for the largest m this instance serves, so the smem of
  // any m <= MT fits the co-residency the occupancy query reported; the
  // opt-in only grows, so a wider h cached earlier keeps its smem
  const size_t smem_max = static_cast<size_t>(MT) * h * sizeof(__nv_bfloat16);
  if (e == cudaSuccess && smem_max > 48 * 1024 && smem_max > smem_attr[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_max));
    if (e == cudaSuccess) smem_attr[dev] = smem_max;
  }
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem_max);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *blocks = sms * (per_sm < kMaxBlocksPerSm ? per_sm : kMaxBlocksPerSm);
  cache[{dev, h}] = *blocks;
  return cudaSuccess;
}

template <int MT>
cudaError_t launch(Args& a, cudaStream_t stream) {
  int dev = 0, blocks = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = grid_blocks<MT>(dev, a.h, &blocks);
  if (e != cudaSuccess) return e;
  auto kernel = q8_layer_fused_kernel<MT>;
  const size_t smem = static_cast<size_t>(a.m) * a.h * sizeof(__nv_bfloat16);
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                     dim3(blocks), dim3(kThreads), args, smem,
                                     stream);
}

}  // namespace

// xm: bf16 [m, qd]; resid: bf16 [m, h]; post_w, next_w: bf16 [h];
// o: int8 [h, qd] + f32 [h, qd/32]; gate_up: [2f, h]; down: [h, f];
// next qkv: [nq, h] (qq == null: no qkv stage, next_w and qkv unused);
// scratch h1: f32 [m, h], act: bf16 [m, f]; out: f32 [m, h]; qkv: f32
// [m, nq]. 1 <= m <= 16, qd, h, f % 32 == 0, 16-byte aligned pointers
// (checked by the wrapper). Returns the launch's cudaError_t: a grid the
// card cannot make co-resident is refused, never run partially.
extern "C" int q8_layer_fused(const void* xm, const void* resid,
                              const void* post_w, const void* next_w,
                              const void* oq, const void* od, const void* gq,
                              const void* gd, const void* dq, const void* dd,
                              const void* qq, const void* qs, void* h1,
                              void* act, void* out, void* qkv, int m, int qd,
                              int h, int f, int nq, float eps, void* stream) {
  if (m < 1 || m > 16 || qd % 32 || h % 32 || f % 32)
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
         m, qd, h, f, nq, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (m == 1) e = launch<1>(a, s);
  else if (m <= 4) e = launch<4>(a, s);
  else e = launch<16>(a, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The co-resident grid K4 launches at row count m and width h (blocks, out
// through `blocks`, an int): what the P2 probe (csrc/q8_probe.cu) runs its
// walk and its barrier-only launch on. Returns a cudaError_t.
extern "C" int q8_layer_fused_grid(int m, int h, void* blocks) {
  if (m < 1 || m > 16 || h % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  int* out = static_cast<int*>(blocks);
  if (e == cudaSuccess) {
    if (m == 1) e = grid_blocks<1>(dev, h, out);
    else if (m <= 4) e = grid_blocks<4>(dev, h, out);
    else e = grid_blocks<16>(dev, h, out);
  }
  return static_cast<int>(e);
}
