// Measurement probes for Hopper (sm_90a): the H100 counterparts of the
// Pallas probes of experiments/, each held against a plain PyTorch version
// by fun_asr_gguf_tpu_torch/probes/. On no path of the engine. (P2, the
// multi-layer walk of K4's chain, is csrc/q8_probe.cu.)
//
// P12 (experiments/q8_mega_probes.py p12 :161-238): one online-softmax
// attention stage over a chunked head-major cache, started from the
// current token — here the split-KV chunk stage and combine that K2 and
// K5 run (split_kv.cuh), launched alone with a chosen chunk, so its time
// can be read against the chunk count.
//
// P5 (experiments/q8_bw_probe.py :92-204): how fast the decode's q8_0 bytes
// stream from HBM. (a) q8_stream_sum touches every byte of the int8 values
// and f32 block scales of 28 layers (o, gate_up, down, qkv: 17.69 MB a
// layer) with 16-byte loads and a trivial sum, as sum_kern :104 does: its
// rate is the achievable stream rate. (b) q8_stream_gemv runs the m = 1
// dequant GEMV of K4 / K5 (q8_gemv.cuh: one warp per output row) over the
// same bytes, as dq_kern :144 does; (c) the same GEMV reading f16 block
// scales (what the GGUF holds), the Hopper form of P5c :186-204.
//
// The small probes, each the function its Pallas kernel computes, written
// for a warp of 32 lanes instead of the TPU's (8, 128) tiles; each moves a
// few KB to 1 MB, so each is bound by its launch, not by bytes:
// P3 (q8_probe.py :282-289) probe_reshape: a row-major reshape, which
//    leaves every element at its flat index: a copy through shared memory.
// P4 (q8_probe.py :297-307) and P6 (q8_mega_probes.py p6 :41-47)
//    probe_scale_expand: bf16(q) * bf16(d) rounded to bf16, out in f32; P4
//    reads f16 scales in the TILED order of concatenate([d] * 32) (lane i
//    takes d[i mod (k / 32)]), P6 f32 scales in the natural q8_0 order
//    (lane i takes d[i / 32]).
// P7 (p7 :59-63) probe_transpose: through a 32 x 33 shared tile, exact.
// P8 (p8 :82-106) NeoX rope, x * cos + rot(x) * sin with rot(x) = [-x[64:],
//    x[:64]]: (a) probe_rope_shuffle, the half swap by lane shuffle (lane i
//    holds columns 4i..4i+3, its partner lane i ^ 16), as K5's prologue
//    ropes (q8_decode_all.cu rope_row); (b) probe_rope_matrix, rot = x . R
//    for a [128, 128] R in f32 FMAs (k ascending).
// P9 (p9 :116-122) probe_batched_dot: hqd,hsd->hqs in f32 FMAs, one warp
//    per slot (lane i: columns 4i..4i+3), a warp-tree sum.
// P10 (p10 :132-138) probe_pair_scale: out[2h:2h+2] = x[2h:2h+2] * (h + 1),
//    one warp per pair of rows, exact.
// P11 (p11 :148-155) probe_head_sum: sum_h kv[h] * (h + 1) in head order,
//    over a head-major [H, S, D] block or a slot-major [S, H, D] one (a
//    strided read per head, equal bytes).
// Products and sums that the plain version rounds one by one use
// __fmul_rn / __fadd_rn (no contraction to an FMA), so P3, P4, P6, P7,
// P8a, P10 and P11 are bit-identical to it; P8b and P9 sum in another
// order and are held to JAX's atol 1e-3.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "q8_gemv.cuh"
#include "split_kv.cuh"

namespace {

// ---------------------------------------------------------------- P12

constexpr int kWarps = 4;
using P12Smem = skv::Smem<__nv_bfloat16, 1>;

struct P12Args {
  const __nv_bfloat16* q;    // [qh, hd]
  const __nv_bfloat16* kc;   // [kh, hd] the current token's k, v
  const __nv_bfloat16* vc;
  const __nv_bfloat16* k;    // [kh, S, hd] head-major cache
  const __nv_bfloat16* v;
  const float* bias;         // [S]
  float* out;                // [qh, hd]
  float* work;               // [kh, nsplit, group (hd + 2)]
  int* tickets;              // [kh]
  int qh, kh, S, chunk, nsplit;
  float scale;
};

struct OutF32 {
  float* out;
  int h0;
  __device__ void operator()(int r, int d, float v) const {
    out[(h0 + r) * skv::kHd + d] = v;
  }
};

__global__ void __launch_bounds__(kWarps * 32) split_kv_probe_kernel(P12Args a) {
  constexpr int D = skv::kHd;
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x, hk = blockIdx.y;
  const int group = a.qh / a.kh;
  __nv_bfloat16* qs = skv::q_rows(smem);
  for (int i = threadIdx.x; i < P12Smem::kRows * (D / 8); i += kWarps * 32) {
    const int r = i / (D / 8), c = i % (D / 8);
    const bool ok = r < group;
    skv::cp_async16(qs + r * P12Smem::kQStride + c * 8,
                    ok ? a.q + (hk * group + r) * D + c * 8 : a.q, ok);
  }
  skv::StageIn in;
  in.k = a.k + static_cast<size_t>(hk) * a.S * D;
  in.v = a.v + static_cast<size_t>(hk) * a.S * D;
  in.stride = D;
  in.ks = in.vs = nullptr;
  in.sstride = 0;
  in.bias = a.bias;
  in.tstride = 0;
  in.group = group;
  in.R = group;
  in.scale = a.scale;
  // work: acc [kh][nsplit][group][D], then m, then l [kh][nsplit][group]
  float* pacc = a.work + static_cast<size_t>(hk) * a.nsplit * group * D;
  float* pm = a.work + static_cast<size_t>(a.kh) * a.nsplit * group * D +
              hk * a.nsplit * group;
  float* pl = pm + a.kh * a.nsplit * group;
  const int s0 = split * a.chunk, s1 = min(a.S, s0 + a.chunk);
  skv::stage<__nv_bfloat16, 1, kWarps>(in, s0, s1, smem, pm + split * group,
                                       pl + split * group,
                                       pacc + split * group * D);
  if (!skv::last_block(a.tickets + hk, a.nsplit,
                       reinterpret_cast<int*>(smem + P12Smem::flag)))
    return;
  // the current token's term: s = q . k_cur * scale, v_cur, in f32
  float* cur = reinterpret_cast<float*>(smem + P12Smem::bytes);   // [D + 16]
  for (int d = threadIdx.x; d < D; d += kWarps * 32)
    cur[d] = __bfloat162float(a.vc[hk * D + d]);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < group) {
    float s = 0.f;
    for (int d = lane; d < D; d += 32)
      s += __bfloat162float(a.q[(hk * group + warp) * D + d]) *
           __bfloat162float(a.kc[hk * D + d]);
    s = skv::warp_sum(s);
    if (lane == 0) cur[D + warp] = s * a.scale;
  }
  __syncthreads();
  skv::combine(pm, pl, pacc, a.nsplit, group, cur + D, cur,
               skv::combine_scratch<__nv_bfloat16, 1>(smem),
               OutF32{a.out, hk * group});
}

// ---------------------------------------------------------------- P5

constexpr int kStreamThreads = 256;

// (a) every byte once: int8 values summed as int, scales as float
__global__ void __launch_bounds__(kStreamThreads)
stream_sum_kernel(const int8_t* q0, const int8_t* q1, const int8_t* q2,
                  const int8_t* q3, const float* d0, const float* d1,
                  const float* d2, const float* d3, long long* isum,
                  float* fsum, int n0, int n1, int n2, int n3) {
  const int8_t* qs[4] = {q0, q1, q2, q3};
  const float* ds[4] = {d0, d1, d2, d3};
  const int ns[4] = {n0, n1, n2, n3};
  const size_t tid = static_cast<size_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  const size_t nthreads = static_cast<size_t>(gridDim.x) * blockDim.x;
  long long si = 0;
  float sf = 0.f;
  for (int m = 0; m < 4; ++m) {
    const int4* qv = reinterpret_cast<const int4*>(qs[m]);
    for (size_t i = tid; i < static_cast<size_t>(ns[m]) / 16; i += nthreads) {
      const int4 v = __ldcs(qv + i);
      const int w[4] = {v.x, v.y, v.z, v.w};
      int acc = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc = __dp4a(w[j], 0x01010101, acc);
      si += acc;
    }
    const float4* dv = reinterpret_cast<const float4*>(ds[m]);
    for (size_t i = tid; i < static_cast<size_t>(ns[m]) / 32 / 4;
         i += nthreads) {
      const float4 v = __ldcs(dv + i);
      sf += (v.x + v.y) + (v.z + v.w);
    }
  }
  __shared__ long long ri[kStreamThreads / 32];
  __shared__ float rf[kStreamThreads / 32];
  for (int o = 16; o > 0; o >>= 1) {
    si += __shfl_xor_sync(0xffffffffu, si, o);
    sf += __shfl_xor_sync(0xffffffffu, sf, o);
  }
  if ((threadIdx.x & 31) == 0) {
    ri[threadIdx.x >> 5] = si;
    rf[threadIdx.x >> 5] = sf;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long ti = 0;
    float tf = 0.f;
    for (int w = 0; w < kStreamThreads / 32; ++w) {
      ti += ri[w];
      tf += rf[w];
    }
    isum[blockIdx.x] = ti;
    fsum[blockIdx.x] = tf;
  }
}

struct GemvArgs {
  const int8_t* q[4];
  const void* d[4];
  const __nv_bfloat16* x;    // [max k]
  float* y;                  // [L, sum n]
  int n[4], k[4], L;
};

// (b), (c): every layer's four m = 1 GEMVs in one launch, through K4 /
// K5's q8_gemv.cuh gemv_rows (one warp per output row), scales of type ST
template <typename ST>
__global__ void __launch_bounds__(q8::kThreads) stream_gemv_kernel(GemvArgs a) {
  const int lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * q8::kWarps + (threadIdx.x >> 5);
  const int nwarps = gridDim.x * q8::kWarps;
  const int ntot = a.n[0] + a.n[1] + a.n[2] + a.n[3];
  for (int l = 0; l < a.L; ++l) {
    int off = 0;
    for (int m = 0; m < 4; ++m) {
      const size_t nk = static_cast<size_t>(a.n[m]) * a.k[m];
      q8::gemv_rows<1, q8::Src::kReadOnly>(
          a.q[m] + l * nk, static_cast<const ST*>(a.d[m]) + l * (nk >> 5),
          a.x, 1, a.k[m], a.n[m], nullptr,
          a.y + static_cast<size_t>(l) * ntot + off, a.n[m], gwarp, nwarps,
          lane);
      off += a.n[m];
    }
  }
}

// ------------------------------------------------------- small probes

constexpr int kProbeThreads = 256;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// P3: y = x through shared memory; one block. A row-major reshape keeps
// every element at its flat index, so on Hopper it is this copy: P3
// measures the launch and the staging through shared memory, nothing more.
__global__ void __launch_bounds__(kProbeThreads)
reshape_kernel(const float* x, float* y, int n) {
  extern __shared__ float tile[];   // [n]
  for (int i = threadIdx.x; i < n; i += blockDim.x) tile[i] = x[i];
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) y[i] = tile[i];
}

// P4 / P6: y[r, c] = bf16(q[r, c] * bf16(d[r, s])), s = c mod (cols / 32)
// (tiled) or c / 32 (natural); one thread per 16 values
template <typename ST, bool kTiled>
__global__ void __launch_bounds__(kProbeThreads)
scale_expand_kernel(const int8_t* q, const ST* d, float* y, int rows,
                    int cols) {
  const size_t g = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= static_cast<size_t>(rows) * cols / 16) return;
  const int nb = cols / 32;
  const int r = static_cast<int>(g * 16 / cols);
  const int c0 = static_cast<int>(g * 16 % cols);
  const int4 qv = __ldg(reinterpret_cast<const int4*>(q) + g);
  const int8_t* qb = reinterpret_cast<const int8_t*>(&qv);
  float o[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = c0 + j;
    const float s = bf16_round(to_f32(d[r * nb + (kTiled ? c % nb : c / 32)]));
    o[j] = bf16_round(static_cast<float>(qb[j]) * s);   // exact, then rounded
  }
  float4* yv = reinterpret_cast<float4*>(y) + g * 4;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    yv[j] = make_float4(o[4 * j], o[4 * j + 1], o[4 * j + 2], o[4 * j + 3]);
}

// P7: y [cols, rows] = x [rows, cols]^T, 32 x 32 tiles
__global__ void __launch_bounds__(kProbeThreads)
transpose_kernel(const float* x, float* y, int rows, int cols) {
  __shared__ float tile[32][33];
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int r = ty; r < 32; r += kProbeThreads / 32)
    if (r0 + r < rows && c0 + tx < cols)
      tile[r][tx] = x[static_cast<size_t>(r0 + r) * cols + c0 + tx];
  __syncthreads();
  for (int c = ty; c < 32; c += kProbeThreads / 32)
    if (c0 + c < cols && r0 + tx < rows)
      y[static_cast<size_t>(c0 + c) * rows + r0 + tx] = tile[tx][c];
}

constexpr int kRopeD = 128;   // P8: 32 lanes x 4 columns

// P8a: one warp per row; the partner of column d +- 64 sits in lane ^ 16
__global__ void __launch_bounds__(kProbeThreads)
rope_shuffle_kernel(const float* q, const float* cos, const float* sin,
                    float* y, int rows) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kProbeThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;   // the whole warp: the shuffle sees full warps
  const float4 v = reinterpret_cast<const float4*>(q + row * kRopeD)[lane];
  const float x[4] = {v.x, v.y, v.z, v.w};
  float o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float p = __shfl_xor_sync(0xffffffffu, x[i], 16);
    const int d = 4 * lane + i;
    o[i] = __fadd_rn(__fmul_rn(x[i], cos[d]),
                     __fmul_rn(lane < 16 ? -p : p, sin[d]));
  }
  reinterpret_cast<float4*>(y + row * kRopeD)[lane] =
      make_float4(o[0], o[1], o[2], o[3]);
}

// P8b: rot = x . R, f32 FMAs over k in order; thread j of a block of 128
// owns column j of 8 rows
constexpr int kRopeRows = 8;
__global__ void __launch_bounds__(kRopeD)
rope_matrix_kernel(const float* q, const float* R, const float* cos,
                   const float* sin, float* y, int rows) {
  __shared__ float xs[kRopeRows][kRopeD];
  const int j = threadIdx.x, r0 = blockIdx.x * kRopeRows;
#pragma unroll
  for (int r = 0; r < kRopeRows; ++r)
    xs[r][j] = r0 + r < rows ? q[(r0 + r) * kRopeD + j] : 0.f;
  __syncthreads();
  float acc[kRopeRows] = {};
  for (int k = 0; k < kRopeD; ++k) {
    const float w = __ldg(R + k * kRopeD + j);
#pragma unroll
    for (int r = 0; r < kRopeRows; ++r) acc[r] = fmaf(xs[r][k], w, acc[r]);
  }
#pragma unroll
  for (int r = 0; r < kRopeRows; ++r)
    if (r0 + r < rows)
      y[(r0 + r) * kRopeD + j] = __fadd_rn(__fmul_rn(xs[r][j], cos[j]),
                                           __fmul_rn(acc[r], sin[j]));
}

// P9: y[b, i, s] = a[b, i, :] . x[b, s, :] over 128 columns, i < m <= 8;
// block (b, 32 slots), one warp per slot in turn
constexpr int kDotMaxRows = 8;
__global__ void __launch_bounds__(kProbeThreads)
batched_dot_kernel(const float* a, const float* x, float* y, int m, int s) {
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float qa[kDotMaxRows][4];
#pragma unroll
  for (int i = 0; i < kDotMaxRows; ++i) {
    if (i < m) {
      const float4 v = reinterpret_cast<const float4*>(
          a + (static_cast<size_t>(b) * m + i) * kRopeD)[lane];
      qa[i][0] = v.x; qa[i][1] = v.y; qa[i][2] = v.z; qa[i][3] = v.w;
    }
  }
  const int s1 = min(s, static_cast<int>(blockIdx.y + 1) * 32);
  for (int t = blockIdx.y * 32 + warp; t < s1; t += kProbeThreads / 32) {
    const float4 v = reinterpret_cast<const float4*>(
        x + (static_cast<size_t>(b) * s + t) * kRopeD)[lane];
#pragma unroll
    for (int i = 0; i < kDotMaxRows; ++i) {
      if (i < m) {
        float p = qa[i][0] * v.x;
        p = fmaf(qa[i][1], v.y, p);
        p = fmaf(qa[i][2], v.z, p);
        p = fmaf(qa[i][3], v.w, p);
        p = q8::warp_sum(p);
        if (lane == 0) y[(static_cast<size_t>(b) * m + i) * s + t] = p;
      }
    }
  }
}

// P10: rows 2h, 2h + 1 times h + 1, one warp per pair of 128-wide rows
__global__ void __launch_bounds__(kProbeThreads)
pair_scale_kernel(const float* x, float* y, int rows) {
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.x * (kProbeThreads / 32) + (threadIdx.x >> 5);
  const float w = static_cast<float>(h + 1);
  for (int r = 2 * h; r < min(rows, 2 * h + 2); ++r) {
    const float4 v = reinterpret_cast<const float4*>(x + r * kRopeD)[lane];
    reinterpret_cast<float4*>(y + r * kRopeD)[lane] =
        make_float4(__fmul_rn(v.x, w), __fmul_rn(v.y, w), __fmul_rn(v.z, w),
                    __fmul_rn(v.w, w));
  }
}

// P11: y[t, :] = sum_h kv(h, t, :) * (h + 1), heads in order; kv
// head-major [heads, s, 128] or slot-major [s, heads, 128]; one thread per
// 4 columns of a slot
__global__ void __launch_bounds__(kProbeThreads)
head_sum_kernel(const float* kv, float* y, int heads, int s, int slot_major) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= s * (kRopeD / 4)) return;
  const int t = g / (kRopeD / 4), c = g % (kRopeD / 4);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int hh = 0; hh < heads; ++hh) {
    const size_t row = slot_major ? static_cast<size_t>(t) * heads + hh
                                  : static_cast<size_t>(hh) * s + t;
    const float4 v = __ldg(reinterpret_cast<const float4*>(kv + row * kRopeD)
                           + c);
    const float w = static_cast<float>(hh + 1);
    acc.x = __fadd_rn(acc.x, __fmul_rn(v.x, w));
    acc.y = __fadd_rn(acc.y, __fmul_rn(v.y, w));
    acc.z = __fadd_rn(acc.z, __fmul_rn(v.z, w));
    acc.w = __fadd_rn(acc.w, __fmul_rn(v.w, w));
  }
  reinterpret_cast<float4*>(y)[g] = acc;
}

int sms(int* n) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(e);
}

}  // namespace

// P12: q bf16 [qh, 128]; kc, vc bf16 [kh, 128]; k, v bf16 [kh, S, 128];
// bias f32 [S]; out f32 [qh, 128]; work f32 [kh ceil(S / chunk) (qh / kh)
// 130]; tickets int32 [kh], zero. qh / kh <= 16, ceil(S / chunk) <= 64.
extern "C" int split_kv_probe(const void* q, const void* kc, const void* vc,
                              const void* k, const void* v, const void* bias,
                              void* out, void* work, void* tickets, int qh,
                              int kh, int S, int chunk, float scale,
                              void* stream) {
  if (kh < 1 || qh % kh || qh / kh > 16 || S < 1 || chunk < 1 ||
      (S + chunk - 1) / chunk > skv::kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = P12Smem::bytes + (skv::kHd + 16) * sizeof(float);
  static std::once_flag once;
  static cudaError_t attr = cudaSuccess;
  std::call_once(once, [smem] {
    attr = cudaFuncSetAttribute(split_kv_probe_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  });
  if (attr != cudaSuccess) return static_cast<int>(attr);
  P12Args a{static_cast<const __nv_bfloat16*>(q),
            static_cast<const __nv_bfloat16*>(kc),
            static_cast<const __nv_bfloat16*>(vc),
            static_cast<const __nv_bfloat16*>(k),
            static_cast<const __nv_bfloat16*>(v),
            static_cast<const float*>(bias), static_cast<float*>(out),
            static_cast<float*>(work), static_cast<int*>(tickets),
            qh, kh, S, chunk, (S + chunk - 1) / chunk, scale};
  split_kv_probe_kernel<<<dim3(a.nsplit, kh), kWarps * 32, smem,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// P5 (a): q0..q3 int8 (n0..n3 bytes, multiples of 512), d0..d3 f32 block
// scales (n / 32 each); isum int64 [blocks], fsum f32 [blocks] per-block
// sums.
extern "C" int q8_stream_sum(const void* q0, const void* q1, const void* q2,
                             const void* q3, const void* d0, const void* d1,
                             const void* d2, const void* d3, void* isum,
                             void* fsum, int n0, int n1, int n2, int n3,
                             int blocks, void* stream) {
  if (blocks < 1 || (n0 | n1 | n2 | n3) % 512)
    return static_cast<int>(cudaErrorInvalidValue);
  stream_sum_kernel<<<blocks, kStreamThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q0), static_cast<const int8_t*>(q1),
      static_cast<const int8_t*>(q2), static_cast<const int8_t*>(q3),
      static_cast<const float*>(d0), static_cast<const float*>(d1),
      static_cast<const float*>(d2), static_cast<const float*>(d3),
      static_cast<long long*>(isum), static_cast<float*>(fsum), n0, n1, n2,
      n3);
  return static_cast<int>(cudaGetLastError());
}

// P5 (b) / (c): stacked q8_0 weights q_m int8 [L, n_m, k_m] with block
// scales d_m [L, n_m, k_m / 32], f32 (f16_scales = 0) or f16 (1); x bf16
// [max k]; y f32 [L, n0 + n1 + n2 + n3]. k_m % 512 == 0.
extern "C" int q8_stream_gemv(const void* q0, const void* q1, const void* q2,
                              const void* q3, const void* d0, const void* d1,
                              const void* d2, const void* d3, const void* x,
                              void* y, int n0, int k0, int n1, int k1, int n2,
                              int k2, int n3, int k3, int L, int f16_scales,
                              void* stream) {
  if (L < 1 || (k0 | k1 | k2 | k3) % 512)
    return static_cast<int>(cudaErrorInvalidValue);
  GemvArgs a{{static_cast<const int8_t*>(q0), static_cast<const int8_t*>(q1),
              static_cast<const int8_t*>(q2), static_cast<const int8_t*>(q3)},
             {d0, d1, d2, d3},
             static_cast<const __nv_bfloat16*>(x),
             static_cast<float*>(y),
             {n0, n1, n2, n3},
             {k0, k1, k2, k3},
             L};
  int n_sm = 0;
  const int e = sms(&n_sm);
  if (e) return e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f16_scales)
    stream_gemv_kernel<__half><<<4 * n_sm, q8::kThreads, 0, st>>>(a);
  else
    stream_gemv_kernel<float><<<4 * n_sm, q8::kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// P3: x, y f32 [rows_in x cols_in] = [rows_out x cols_out] elements, at
// most 12288 (48 KB of shared memory).
extern "C" int probe_reshape(const void* x, void* y, int rows_in,
                             int cols_in, int rows_out, int cols_out,
                             void* stream) {
  const int n = rows_in * cols_in;
  if (rows_in < 1 || cols_in < 1 || rows_out < 1 || cols_out < 1 ||
      rows_out * cols_out != n || n > 12288)
    return static_cast<int>(cudaErrorInvalidValue);
  reshape_kernel<<<1, kProbeThreads, n * sizeof(float),
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n);
  return static_cast<int>(cudaGetLastError());
}

// P4 / P6: q int8 [rows, cols]; d [rows, cols / 32], f16 (f16_scales = 1)
// or f32; y f32 [rows, cols]; tiled = 1: P4's order, 0: the natural one.
// cols % 32 == 0, 16-byte aligned q and y.
extern "C" int probe_scale_expand(const void* q, const void* d, void* y,
                                  int rows, int cols, int f16_scales,
                                  int tiled, void* stream) {
  if (rows < 1 || cols < 32 || cols % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = rows * cols / 16;
  const int blocks = (groups + kProbeThreads - 1) / kProbeThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* qp = static_cast<const int8_t*>(q);
  float* yp = static_cast<float*>(y);
  if (f16_scales && tiled)
    scale_expand_kernel<__half, true><<<blocks, kProbeThreads, 0, st>>>(
        qp, static_cast<const __half*>(d), yp, rows, cols);
  else if (f16_scales)
    scale_expand_kernel<__half, false><<<blocks, kProbeThreads, 0, st>>>(
        qp, static_cast<const __half*>(d), yp, rows, cols);
  else if (tiled)
    scale_expand_kernel<float, true><<<blocks, kProbeThreads, 0, st>>>(
        qp, static_cast<const float*>(d), yp, rows, cols);
  else
    scale_expand_kernel<float, false><<<blocks, kProbeThreads, 0, st>>>(
        qp, static_cast<const float*>(d), yp, rows, cols);
  return static_cast<int>(cudaGetLastError());
}

// P7: x f32 [rows, cols] -> y f32 [cols, rows].
extern "C" int probe_transpose(const void* x, void* y, int rows, int cols,
                               void* stream) {
  if (rows < 1 || cols < 1) return static_cast<int>(cudaErrorInvalidValue);
  transpose_kernel<<<dim3((cols + 31) / 32, (rows + 31) / 32), kProbeThreads,
                     0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), rows, cols);
  return static_cast<int>(cudaGetLastError());
}

// P8a: q, y f32 [rows, 128]; cos, sin f32 [128]; 16-byte aligned q, y.
extern "C" int probe_rope_shuffle(const void* q, const void* cos,
                                  const void* sin, void* y, int rows,
                                  void* stream) {
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int per = kProbeThreads / 32;
  rope_shuffle_kernel<<<(rows + per - 1) / per, kProbeThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(cos),
      static_cast<const float*>(sin), static_cast<float*>(y), rows);
  return static_cast<int>(cudaGetLastError());
}

// P8b: q, y f32 [rows, 128]; R f32 [128, 128]; cos, sin f32 [128].
extern "C" int probe_rope_matrix(const void* q, const void* r,
                                 const void* cos, const void* sin, void* y,
                                 int rows, void* stream) {
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  rope_matrix_kernel<<<(rows + kRopeRows - 1) / kRopeRows, kRopeD, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(r),
      static_cast<const float*>(cos), static_cast<const float*>(sin),
      static_cast<float*>(y), rows);
  return static_cast<int>(cudaGetLastError());
}

// P9: a f32 [batch, m, 128], x f32 [batch, s, 128] -> y f32 [batch, m, s];
// 1 <= m <= 8; 16-byte aligned a, x.
extern "C" int probe_batched_dot(const void* a, const void* x, void* y,
                                 int batch, int m, int s, void* stream) {
  if (batch < 1 || m < 1 || m > kDotMaxRows || s < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  batched_dot_kernel<<<dim3(batch, (s + 31) / 32), kProbeThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(x),
      static_cast<float*>(y), m, s);
  return static_cast<int>(cudaGetLastError());
}

// P10: x, y f32 [rows, 128]; 16-byte aligned.
extern "C" int probe_pair_scale(const void* x, void* y, int rows,
                                void* stream) {
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int pairs = (rows + 1) / 2, per = kProbeThreads / 32;
  pair_scale_kernel<<<(pairs + per - 1) / per, kProbeThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), rows);
  return static_cast<int>(cudaGetLastError());
}

// P11: kv f32 [heads, s, 128] (slot_major = 0) or [s, heads, 128] (1);
// y f32 [s, 128]; 16-byte aligned.
extern "C" int probe_head_sum(const void* kv, void* y, int heads, int s,
                              int slot_major, void* stream) {
  if (heads < 1 || s < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int n = s * (kRopeD / 4);
  head_sum_kernel<<<(n + kProbeThreads - 1) / kProbeThreads, kProbeThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(kv), static_cast<float*>(y), heads, s,
      slot_major);
  return static_cast<int>(cudaGetLastError());
}
