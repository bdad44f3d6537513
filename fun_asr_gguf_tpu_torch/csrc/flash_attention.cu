// K3 — masked non-causal encoder attention for Hopper (sm_90a).
//
// out[b, h, i, :] = softmax_j(q[b, h, i] . k[b, h, j] + bias[b, j]) @ v[b, h]
//
// Replaces the Pallas kernel fun_asr_gguf_tpu/ops/flash_attention.py
// flash_attention (:90, pallas_call :116; used through attention_with_mask
// by every SANM layer). Same numerics class: dot operands in bf16 with f32
// accumulation, online softmax with f32 statistics starting from m = -1e9
// (NEG_BIG), the probabilities rounded to bf16 for the P.V product, output
// divided by max(l, 1e-30). The key bias is the reference's (mask - 1) *
// 1e4 row, one per batch row; the ragged edge of T is masked HERE (keys >=
// T never enter the softmax, query rows >= T are not stored) instead of
// padding T up to a tile multiple.
//
// What bounds it: operations. At the encoder's BH = 4, T = 1001, D = 128
// the four T x T x D products are 2.05 GFLOP of bf16 tensor-core work (2.1
// us at 989 TFLOP/s) against 3 MB of q, k, v and out.
//
// Design. The mma.sync kernel this replaces gave each 64-row query tile
// one block of 4 warps (64 blocks on 132 SMs) walking all 16 key tiles,
// each loaded synchronously, V transposed by scalar shared stores. Here:
// - A block takes 128 query rows, 64 for each of two consumer warpgroups,
//   and one contiguous range of 64-key tiles: the keys of a query tile
//   are split into `chunks` ranges, one block each, the blocks of a tile
//   one thread-block cluster (ops/flash_attention.py attention_chunks: 2
//   at the encoder's shape, 64 blocks of 8 key tiles).
// - S = Q.K^T is wgmma m64n64k16 with Q and K from shared memory
//   (K-major, 128-byte swizzle); O += P.V is wgmma m64nDk16 with P from
//   registers (the S accumulator rounded to bf16 is the A fragment) and V
//   read as the MN-major B operand straight from its row-major tile
//   (transpose bit): no scalar transpose. The two warpgroups share each
//   K / V tile; one's softmax runs while the other's wgmma do.
// - A producer warp copies Q, and K, V and the tile's 64 bias values into
//   a ring of kStages stages, by TMA from tensor maps over the (batch,
//   head, row) strides of q, k, v (so the SANM views of the packed qkv
//   projection need no copy; keys past T arrive as zeros); a stage's
//   mbarrier completes when its bytes have landed, a second one when the
//   consumer warps are done with it.
// - A block keeps its chunk's (m, l, o). Block c of the cluster owns rows
//   [128 c / chunks, 128 (c + 1) / chunks) of the tile: after a cluster
//   barrier every block stores its partials of those rows into the
//   owner's shared memory, and after a second one the owner combines them
//   in rank order, o = sum_c e^(m_c - M) o_c, l likewise, M the largest
//   m_c: a fixed order, so the result repeats bit for bit; a chunk with no
//   key (past T) keeps l = 0 and o = 0 and weighs nothing.
// - out is written by its strides too, in the [B, T, H, D] order the next
//   projection reads.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <set>
#include <utility>

#include "wgmma.cuh"

namespace {

constexpr int kKeys = 64;           // keys of a tile, query rows of a group
constexpr int kGroups = 2;          // consumer warpgroups
constexpr int kRows = kKeys * kGroups;   // query rows of a block
constexpr int kConsumerWarps = 4 * kGroups;
constexpr int kThreads = 32 * kConsumerWarps + 32;   // and a producer warp
constexpr int kStages = 4;          // K / V ring
constexpr int kMaxChunks = 8;       // portable cluster size
constexpr int kPanel = 64 * 128;    // 64 rows of 64 bf16
constexpr float NEG_BIG = -1e9f;

// dynamic shared memory: the Q tiles of the two groups, kStages K and V
// tiles, kStages bias rows, the mbarriers; after the last tile, over the
// same bytes, this block's partials (o, m, l) of its 128 rows, then the
// receive slots of the other chunks' partials of the rows it owns
template <int D>
struct Layout {
  static constexpr int kTile = (D / 64) * kPanel;   // 64 rows of D bf16
  static constexpr int kK = kGroups * kTile;        // stage s: K at kK + 2
                                                    // s kTile, V after it
  static constexpr int kBias = kK + 2 * kStages * kTile;
  static constexpr int kBars = kBias + kStages * kKeys * 4;
  static constexpr int kBytes = kBars + 2 * kStages * 8 + 1024;  // + align
  static constexpr int kOStride = D + 8;                     // floats
  static constexpr int kM = kRows * kOStride * 4;            // m, then l
  static constexpr int kR = kM + 2 * kRows * 4;              // receive slots
  static_assert(2 * kR <= kBias, "the partials fit in the ring");
  static constexpr unsigned kQBytes = kGroups * kTile;
  static constexpr unsigned kStageBytes = 2 * kTile + kKeys * 4;
};

struct Args {
  CUtensorMap q, k, v;    // bf16 [B, H, T, D]: boxes of 64 rows x 64 dims,
                          // the outer dims in the order of their strides
  CUtensorMap bias;       // f32 [B, T]: boxes of 64 keys
  __nv_bfloat16* out;
  long long so[3];        // out's batch, head, row strides (elements)
  int H, T, tiles_per_chunk;
  int dim_of[3];          // the map dim (1..3) of the row, head and batch
};

// a 64 x 64 box of q, k or v at (row, head h, batch b), head dims from
// d0; dim: Args::dim_of
__device__ __forceinline__ void tma_rows(unsigned dst, const CUtensorMap* map,
                                         const int (&dim)[3], int d0, int row,
                                         int h, int b, uint64_t* bar) {
  int c[4] = {d0, 0, 0, 0};
  c[dim[0]] = row;
  c[dim[1]] = h;
  c[dim[2]] = b;
  wg::tma_4d(dst, map, c[0], c[1], c[2], c[3], bar);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const __grid_constant__ Args a) {
  using L = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned for the swizzle, and derived from the __shared__
  // array so that its accesses compile to shared-memory instructions
  unsigned char* sm =
      smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  float* bias_s = reinterpret_cast<float*>(sm + L::kBias);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* empty = full + kStages;
  const unsigned base = wg::smem_u32(sm);
  auto ka = [&](int s) { return base + L::kK + 2 * s * L::kTile; };
  auto va = [&](int s) { return base + L::kK + (2 * s + 1) * L::kTile; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int chunk = blockIdx.x, chunks = gridDim.x;
  const int q0 = blockIdx.y * kRows, T = a.T;
  const int b = blockIdx.z / a.H, h = blockIdx.z - b * a.H;
  const int ntiles = (T + kKeys - 1) / kKeys;
  const int j0 = chunk * a.tiles_per_chunk;
  const int n = max(0, min(ntiles, j0 + a.tiles_per_chunk) - j0);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      wg::bar_init(&full[s], 1);                // the producer's expect
      wg::bar_init(&empty[s], kConsumerWarps);  // the consumer warps
    }
    wg::bar_init_fence();
  }
  __syncthreads();

  float o[D / 2];
  float m_r[2] = {NEG_BIG, NEG_BIG}, l_r[2] = {0.f, 0.f};
  if (warp == kConsumerWarps) {
    // producer: the Q tiles with the first stage, then K, V and the bias
    // of each tile once its slot is free
    if (lane == 0) {
      const int dim[3] = {a.dim_of[0], a.dim_of[1], a.dim_of[2]};
      for (int j = 0; j < n; ++j) {
        const int s = j % kStages;
        if (j >= kStages) {
          wg::bar_wait(&empty[s], (j / kStages - 1) & 1);
          wg::fence_async_smem();
        }
        wg::bar_expect(&full[s], L::kStageBytes + (j == 0 ? L::kQBytes : 0));
        if (j == 0) {
#pragma unroll
          for (int g = 0; g < kGroups; ++g)
#pragma unroll
            for (int p = 0; p < D / 64; ++p)
              tma_rows(base + g * L::kTile + p * kPanel, &a.q, dim, 64 * p,
                       q0 + g * kKeys, h, b, &full[0]);
        }
        const int key0 = (j0 + j) * kKeys;
#pragma unroll
        for (int p = 0; p < D / 64; ++p) {
          tma_rows(ka(s) + p * kPanel, &a.k, dim, 64 * p, key0, h, b,
                   &full[s]);
          tma_rows(va(s) + p * kPanel, &a.v, dim, 64 * p, key0, h, b,
                   &full[s]);
        }
        wg::tma_2d(wg::smem_u32(bias_s + s * kKeys), &a.bias, key0, b,
                   &full[s]);
      }
    }
  } else {
    const int t = lane & 3;
    const unsigned qa = base + (warp >> 2) * L::kTile;   // this group's Q
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    for (int j = 0; j < n; ++j) {
      const int s = j % kStages;
      wg::bar_wait(&full[s], (j / kStages) & 1);

      // S = Q K^T: this warp's 16 rows x 64 keys
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      wg::reg_fence(sc);
      wg::mma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const unsigned off = (kk >> 2) * kPanel + (kk & 3) * 32;
        wg::mma_ss_n64(sc, wg::desc(qa + off, 16, 1024),
                       wg::desc(ka(s) + off, 16, 1024), 1);
      }
      wg::mma_commit();
      wg::mma_wait<0>();
      wg::reg_fence(sc);

      // bias + ragged-edge mask, online softmax (rows g and g + 8)
      const int key0 = (j0 + j) * kKeys;
      const float* bt = bias_s + s * kKeys;
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = jj * 8 + 2 * t + (e & 1);
          const float val =
              key0 + col < T ? sc[4 * jj + e] + bt[col] : -INFINITY;
          sc[4 * jj + e] = val;
          mx[e >> 1] = fmaxf(mx[e >> 1], val);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      float scale[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) scale[r] = __expf(m_r[r] - mx[r]);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float p = __expf(sc[i] - mx[(i >> 1) & 1]);
        sc[i] = p;
        rs[(i >> 1) & 1] += p;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        l_r[r] = l_r[r] * scale[r] + rs[r];
        m_r[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= scale[(i >> 1) & 1];

      // O += P V: the S accumulators of keys [16 kk, 16 kk + 16) are the
      // A fragment of step kk
      uint32_t pf[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pf[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
      }
      wg::reg_fence(o);
      wg::mma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv = wg::desc(va(s) + kk * 2048, kPanel, 1024);
        if constexpr (D == 128)
          wg::mma_rs_n128<1>(o, pf[kk], dv, 1);
        else
          wg::mma_rs_n64<1>(o, pf[kk], dv, 1);
      }
      wg::mma_commit();
      wg::mma_wait<0>();
      wg::reg_fence(o);
      if (lane == 0) wg::bar_arrive(&empty[s]);   // this warp is done with s
    }
  }

  const int t = lane & 3;
  const int r0 = (warp >> 2) * kKeys + (warp & 3) * 16 + (lane >> 2);
  const int r1 = r0 + 8;
  const bool consumer = warp < kConsumerWarps;
  __nv_bfloat16* og = a.out + b * a.so[0] + h * a.so[1];
  const long long so = a.so[2];
  if (chunks == 1) {
    if (!consumer) return;
    const float inv[2] = {1.f / fmaxf(l_r[0], 1e-30f),
                          1.f / fmaxf(l_r[1], 1e-30f)};
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      const int c = jj * 8 + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + (r ? r1 : r0);
        if (row < T)
          *reinterpret_cast<__nv_bfloat162*>(og + row * so + c) =
              __floats2bfloat162_rn(o[4 * jj + 2 * r] * inv[r],
                                    o[4 * jj + 2 * r + 1] * inv[r]);
      }
    }
    return;
  }

  // The chunk's partials, staged in this block's ring as [row][D] (o)
  // and [row] (m, l); block c owns rows [c per, (c + 1) per) of the tile.
  // After a cluster barrier each block pushes the rows every other block
  // owns into that block's receive slot for it, and after a second one
  // each block combines its rows over the chunks in rank order.
  const int per = kRows / chunks;
  float* po = reinterpret_cast<float*>(sm);
  float* pm = reinterpret_cast<float*>(sm + L::kM);
  float* pl = pm + kRows;
  __syncthreads();                     // the ring is free
  if (consumer) {
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      const int c = jj * 8 + 2 * t;
      *reinterpret_cast<float2*>(po + r0 * L::kOStride + c) =
          make_float2(o[4 * jj], o[4 * jj + 1]);
      *reinterpret_cast<float2*>(po + r1 * L::kOStride + c) =
          make_float2(o[4 * jj + 2], o[4 * jj + 3]);
    }
    if (t == 0) {
      pm[r0] = m_r[0];
      pm[r1] = m_r[1];
      pl[r0] = l_r[0];
      pl[r1] = l_r[1];
    }
  }
  wg::cluster_sync();         // staged everywhere; every ring is free
  for (int q = 0; q < chunks; ++q) {
    if (q == chunk) continue;
    const unsigned rb = wg::remote(base + L::kR, q);
    const int slot = chunk < q ? chunk : chunk - 1;   // q's slot for us
    wg::push(rb + slot * per * L::kOStride * 4,
             reinterpret_cast<const float4*>(po + q * per * L::kOStride),
             per * L::kOStride / 4, tid, kThreads);
    wg::push(rb + L::kM + slot * per * 4,
             reinterpret_cast<const float4*>(pm + q * per), per / 4, tid,
             kThreads);
    wg::push(rb + L::kM + (kRows + slot * per) * 4,
             reinterpret_cast<const float4*>(pl + q * per), per / 4, tid,
             kThreads);
  }
  wg::cluster_sync();                  // the partials have landed
  const float* ro = reinterpret_cast<const float*>(sm + L::kR);
  const float* rm = reinterpret_cast<const float*>(sm + L::kR + L::kM);
  const float* rl = rm + kRows;
  // row lr of chunk q: ours in the staged rows, the others' in their slots
  auto at = [&](int q, int lr) {
    return q == chunk ? chunk * per + lr : (q < chunk ? q : q - 1) * per + lr;
  };
  constexpr int kCols = D / 4;         // float4 of a row
  for (int i = tid; i < per * kCols; i += kThreads) {
    const int lr = i / kCols, c = (i % kCols) * 4;
    float M = NEG_BIG;
    for (int q = 0; q < chunks; ++q)
      M = fmaxf(M, (q == chunk ? pm : rm)[at(q, lr)]);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    float l = 0.f;
    for (int q = 0; q < chunks; ++q) {
      const int r = at(q, lr);
      const float w = __expf((q == chunk ? pm : rm)[r] - M);
      const float4 v = *reinterpret_cast<const float4*>(
          (q == chunk ? po : ro) + r * L::kOStride + c);
      l += w * (q == chunk ? pl : rl)[r];
      acc.x += w * v.x;
      acc.y += w * v.y;
      acc.z += w * v.z;
      acc.w += w * v.w;
    }
    const int row = q0 + chunk * per + lr;
    if (row < T) {
      const float inv = 1.f / fmaxf(l, 1e-30f);
      __nv_bfloat162* dst =
          reinterpret_cast<__nv_bfloat162*>(og + row * so + c);
      dst[0] = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
      dst[1] = __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
    }
  }
}

std::mutex attr_mu;
std::set<std::pair<int, const void*>> attr_set;

template <int D>
cudaError_t launch(const Args& a, int bh, int chunks, cudaStream_t s) {
  const void* kernel = reinterpret_cast<const void*>(flash_attention_kernel<D>);
  const int smem = Layout<D>::kBytes;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  {
    std::lock_guard<std::mutex> lock(attr_mu);
    if (!attr_set.count({dev, kernel})) {
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
      if (e != cudaSuccess) return e;
      attr_set.insert({dev, kernel});
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(chunks, (a.T + kRows - 1) / kRows, bh);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = chunks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, flash_attention_kernel<D>, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// q (pre-scaled), k, v: bf16 [B, H, T, D] by their element strides
// (batch, head, row; the head dims contiguous), out likewise; bias: f32
// rows [B, T], `sb` elements apart. `strides` (host memory, 12 int64):
// q's, k's, v's and out's (batch, head, row). D in {64, 128}; chunks in
// {1, 2, 4, 8}, at most the 64-key tiles of T; q, k, v 16-byte aligned
// with strides of 8 elements, bias rows 16-byte aligned, out's strides
// even (checked by the wrapper).
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, const void* bias,
                                    void* out, const void* strides,
                                    long long sb, int B, int H, int T, int D,
                                    int chunks, void* stream) {
  const long long* st = static_cast<const long long*>(strides);
  const int tiles = (T + kKeys - 1) / kKeys;
  if (B < 1 || H < 1 || T < 1 || (D != 64 && D != 128) || chunks < 1
      || chunks > kMaxChunks || (chunks & (chunks - 1)) || chunks > tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  // the outer dims (row, head, batch) of q's map in the order of q's
  // strides; k and v take the same order (SANM's three views share it)
  const long long row_hb[3] = {st[2], st[1], st[0]};
  int order[3] = {0, 1, 2};
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && row_hb[order[j]] < row_hb[order[j - 1]]; --j) {
      const int tmp = order[j];
      order[j] = order[j - 1];
      order[j - 1] = tmp;
    }
  for (int i = 0; i < 3; ++i) a.dim_of[order[i]] = 1 + i;
  const void* ptrs[3] = {q, k, v};
  CUtensorMap* maps[3] = {&a.q, &a.k, &a.v};
  const int sizes[3] = {T, H, B};
  for (int i = 0; i < 3; ++i) {
    const long long mine[3] = {st[3 * i + 2], st[3 * i + 1], st[3 * i]};
    cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), 0, 0, 0};
    cuuint64_t bytes[3];
    for (int j = 0; j < 3; ++j) {
      dims[1 + j] = static_cast<cuuint64_t>(sizes[order[j]]);
      bytes[j] = static_cast<cuuint64_t>(mine[order[j]]) * 2;
    }
    cuuint32_t box[4] = {64, 1, 1, 1};
    box[a.dim_of[0]] = kKeys;
    const int e = wg::tensor_map(maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                                 ptrs[i], dims, bytes, box,
                                 CU_TENSOR_MAP_SWIZZLE_128B);
    if (e) return e;
  }
  {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(T),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t bytes[1] = {static_cast<cuuint64_t>(sb) * 4};
    const cuuint32_t box[2] = {kKeys, 1};
    const int e = wg::tensor_map(&a.bias, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                                 bias, dims, bytes, box,
                                 CU_TENSOR_MAP_SWIZZLE_NONE);
    if (e) return e;
  }
  a.out = static_cast<__nv_bfloat16*>(out);
  for (int i = 0; i < 3; ++i) a.so[i] = st[9 + i];
  a.H = H;
  a.T = T;
  a.tiles_per_chunk = (tiles + chunks - 1) / chunks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128) return static_cast<int>(launch<128>(a, B * H, chunks, s));
  return static_cast<int>(launch<64>(a, B * H, chunks, s));
}
