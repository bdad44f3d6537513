// P2 — one cooperative launch that walks every layer of K4a's chain, for
// Hopper (sm_90a): the H100 counterpart of experiments/q8_probe.py's P2
// (`mega_multi`, pallas_call :247), one call with grid (28 * steps,) that
// runs the staged chain's four stages on each layer's weights in turn.
//
// Per layer l, on the SAME inputs xm [qd] bf16 and res [h] f32 (the layers
// do not chain, as in P2):
//
//   h1  = xm . o[l]^T + res                                  (f32)
//   act = bf16(silu(nh . gate^T) * (nh . up^T)), nh = bf16(rmsnorm(h1) * pw)
//   out = act . down[l]^T + h1                               (f32)
//   qkv = bf16(rmsnorm(out) * nw) . qkv[l]^T                 (f32)
//
// and the last layer's out and qkv are the result. The stages are K4's
// (q8_gemv.cuh: rows_dot through gemv_rows and gate_up_rows, and
// rms_rows_to_smem), at K4's co-resident grid (q8_layer_fused_grid), with
// K4's three grid barriers a layer (after o, after gate_up, after down).
// Layer-to-layer reuse of the scratch needs none more: layer l + 1 writes
// h1 in its first stage, after layer l's third barrier, when every block
// has read h1 for the last time (gate_up's norm, down's residual); it
// writes act after its first barrier and out after its second, when every
// block has left layer l's down and qkv stages that read them. So a layer
// takes 3 barriers, 84 at 28 layers: the walk has no call boundary, and
// P1 (28 K4 launches) against P2 is the per-call fixed cost.
//
// Barrier-only mode (`barriers` > 0): the same kernel, launch and grid,
// `barriers` grid.sync() and no stage, so no byte is read or written. At
// K4's grid with 3 L barriers it is P2's barrier cost; at K5's grid
// (q8_decode_all_grid) with 5 L it is K5's (q8_decode_all.cu: five a
// layer).
//
// What bounds it: bytes, 17.69 MB of int8 and f32 scales a layer at
// Qwen3-0.6B width (495.45 MB over 28 layers, ten times the L2), a
// 0.148 ms floor at 3.35 TB/s; the barriers and each stage's fixed cost
// are what the probe measures against it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "q8_gemv.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace q8;

struct P2Args {
  const __nv_bfloat16* xm;      // [qd]
  const float* res;             // [h]
  const __nv_bfloat16* pw;      // [h]  post norm
  const __nv_bfloat16* nw;      // [h]  next input norm
  const int8_t* oq;             // [L, h, qd] + f32 [L, h, qd/32]
  const float* od;
  const int8_t* gq;             // [L, 2f, h] gate rows, then up rows
  const float* gd;
  const int8_t* dq;             // [L, h, f]
  const float* dd;
  const int8_t* qq;             // [L, nq, h]
  const float* qs;
  float* h1;                    // scratch [h]
  __nv_bfloat16* act;           // scratch [f]
  float* out;                   // [h]
  float* qkv;                   // [nq]
  int L, qd, h, f, nq;
  float eps;
  int barriers;                 // > 0: barrier-only mode
};

__global__ void __launch_bounds__(kThreads) q8_probe_p2_kernel(P2Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* nh = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [h]
  cg::grid_group grid = cg::this_grid();
  if (a.barriers > 0) {
    for (int i = 0; i < a.barriers; ++i) grid.sync();
    return;
  }
  const int lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int nwarps = gridDim.x * kWarps;
  const int qd = a.qd, h = a.h, f = a.f, nq = a.nq;
  for (int l = 0; l < a.L; ++l) {
    const size_t li = l;
    // h1 = xm . o[l]^T + res
    gemv_rows<1, Src::kReadOnly>(a.oq + li * h * qd, a.od + li * h * (qd >> 5),
                                 a.xm, 1, qd, h, a.res, a.h1, h, gwarp,
                                 nwarps, lane);
    grid.sync();
    // act = bf16(silu(nh . gate^T) * (nh . up^T))
    rms_rows_to_smem(a.h1, a.pw, 1, h, a.eps, nh);
    __syncthreads();
    gate_up_rows<1>(a.gq + li * 2 * f * h, a.gd + li * 2 * f * (h >> 5), nh,
                    1, h, f, a.act, gwarp, nwarps, lane);
    grid.sync();
    // out = act . down[l]^T + h1
    gemv_rows<1, Src::kL2>(a.dq + li * h * f, a.dd + li * h * (f >> 5),
                           a.act, 1, f, h, a.h1, a.out, h, gwarp, nwarps,
                           lane);
    grid.sync();
    // qkv = bf16(rmsnorm(out) * nw) . qkv[l]^T
    rms_rows_to_smem(a.out, a.nw, 1, h, a.eps, nh);
    __syncthreads();
    gemv_rows<1, Src::kShared>(a.qq + li * nq * h, a.qs + li * nq * (h >> 5),
                               nh, 1, h, nq, nullptr, a.qkv, nq, gwarp,
                               nwarps, lane);
  }
}

}  // namespace

// xm bf16 [qd]; res f32 [h]; pw, nw bf16 [h]; o int8 [L, h, qd] + f32
// [L, h, qd/32]; gate_up [L, 2f, h]; down [L, h, f]; qkv [L, nq, h];
// scratch h1 f32 [h], act bf16 [f]; out f32 [h]; qkv f32 [nq]. barriers
// > 0: barrier-only mode (no pointer is read or written). blocks: the grid
// (K4's or K5's, from their *_grid queries), refused unless co-resident.
// qd, h, f % 32 == 0, 16-byte aligned pointers (checked by the wrapper).
extern "C" int q8_probe_p2(const void* xm, const void* res, const void* pw,
                           const void* nw, const void* oq, const void* od,
                           const void* gq, const void* gd, const void* dq,
                           const void* dd, const void* qq, const void* qs,
                           void* h1, void* act, void* out, void* qkv, int L,
                           int qd, int h, int f, int nq, float eps,
                           int barriers, int blocks, void* stream) {
  if (L < 1 || barriers < 0 || blocks < 1 || qd % 32 || h % 32 || f % 32 ||
      h > 16384)
    return static_cast<int>(cudaErrorInvalidValue);
  P2Args a{static_cast<const __nv_bfloat16*>(xm),
           static_cast<const float*>(res),
           static_cast<const __nv_bfloat16*>(pw),
           static_cast<const __nv_bfloat16*>(nw),
           static_cast<const int8_t*>(oq), static_cast<const float*>(od),
           static_cast<const int8_t*>(gq), static_cast<const float*>(gd),
           static_cast<const int8_t*>(dq), static_cast<const float*>(dd),
           static_cast<const int8_t*>(qq), static_cast<const float*>(qs),
           static_cast<float*>(h1), static_cast<__nv_bfloat16*>(act),
           static_cast<float*>(out), static_cast<float*>(qkv),
           L, qd, h, f, nq, eps, barriers};
  const size_t smem = static_cast<size_t>(h) * sizeof(__nv_bfloat16);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, q8_probe_p2_kernel, kThreads, smem);
  if (e == cudaSuccess && blocks > sms * per_sm)
    e = cudaErrorCooperativeLaunchTooLarge;
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(q8_probe_p2_kernel),
                                  dim3(blocks), dim3(kThreads), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
