// K6: masked fused trailing update C <- C - op(X) Y on Hopper (sm_90a), f32.
//
// Replaces the Pallas TPU kernel dlaf_tpu/ops/pallas/trailing.py
// ksub_matmul_masked (_ksub_kernel_masked): the distributed POTRF's
// trailing updates, C - op(X) Y only where grow[i] >= gcol[j] (int32 global
// row and column indices; a sentinel column index above every row index,
// or both vectors negated for the upper mask i <= j, are plain compares).
// As there, the product and the subtract share one accumulator and the
// product never reaches device memory; C is read once and written once, in
// place. This tile was K2's first design too (the same kernel without the
// mask); K2 now runs on the tensor cores (ksub_tf32x3.cu).
//
// What bounds it: at n = 32768 on one card the heaviest call is m = 30720,
// n = 1536, k = 2048: a large f32 GEMM, bound by the SMs' f32 FFMA rate (67
// TFLOP/s on an H100 SXM at 700 W). The products are plain f32 FFMA.
//
// Design: a 128 x 128 output tile per block of 256 threads, each thread
// an 8 x 8 register tile (rows ty*4 + {0..3, 64..67}, columns tx*4 +
// {0..3, 64..67}, so shared-memory reads are float4 and conflict-free).
// K advances 8 at a time through two shared-memory buffers: the next
// step's tiles are loaded into registers while the current step computes.
// X arrives K-major (k, m) or (m, k) (NN); both are stored K-major in
// shared memory (row stride 132 keeps the transposing store of the NN
// layout free of bank conflicts). Every operand takes a leading dimension,
// so row-strided views into the factored matrix go in without copies, and
// the kernel masks the ragged edges of m, n and k.
//
// Small grids: when there are fewer output tiles than SMs, a thread block
// cluster of S <= 8 blocks shares each output tile and splits k S ways
// (a separate instantiation, so the unsplit kernel carries none of it).
// Each block leaves its partial tile in its own shared memory; after a
// cluster barrier, block r sums rows [r*128/S, (r+1)*128/S) of all S
// partials through distributed shared memory, in the fixed order 0..S-1
// (deterministic), and subtracts the sum from C. The partial products stay
// on chip, and C is still read once and written once.
//
// The mask: each block first loads its tile's slice of grow and gcol into
// shared memory and reduces max(grow) and min(gcol). A dead tile (max <
// min: wholly above the diagonal) returns at once, so C is neither read
// nor written there and the staircase's conservative chunks cost only
// their live tiles. A live tile accumulates and subtracts in the epilogue
// only where the mask holds; entries outside it are not written.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int BM = 128, BN = 128, BK = 8;
constexpr int kAStride = BM + 4;
constexpr int kLoads = BM * BK / kThreads;   // elements per thread per tile
constexpr int kMaxSplit = 8;                 // portable cluster size
constexpr size_t kSplitSmem = sizeof(float) * BM * BN;   // one partial tile
static_assert(kThreads == BM + BN, "K6 loads one index per thread");

// C[gm][gn..gn+3] -= v, float4 where aligned and whole
__device__ __forceinline__ void sub4(float* c, long long ldc, bool vec, int gm, int gn,
                                     int n, float4 v) {
  float* p = c + gm * ldc + gn;
  if (vec && gn + 3 < n) {
    float4 o = *reinterpret_cast<float4*>(p);
    o.x -= v.x; o.y -= v.y; o.z -= v.z; o.w -= v.w;
    *reinterpret_cast<float4*>(p) = o;
  } else {
    const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (gn + j < n) p[j] -= w[j];
  }
}

// sub4 where gr >= gc[j] (K6's mask): entries outside it are not written
__device__ __forceinline__ void sub4_masked(float* c, long long ldc, bool vec, int gm, int gn,
                                            int n, float4 v, int gr, const int* gc) {
  const bool keep[4] = {gr >= gc[0], gr >= gc[1], gr >= gc[2], gr >= gc[3]};
  if (keep[0] && keep[1] && keep[2] && keep[3]) {
    sub4(c, ldc, vec, gm, gn, n, v);
    return;
  }
  float* p = c + gm * ldc + gn;
  const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (keep[j] && gn + j < n) p[j] -= w[j];
}

// two blocks per SM (<= 128 registers a thread) is what hides the latency
template <bool kSplit>
__global__ void __launch_bounds__(kThreads, 2)
ksub_kernel(float* __restrict__ c, long long ldc, const float* __restrict__ x,
            long long ldx, const float* __restrict__ y, long long ldy,
            int m, int n, int k, int x_k_major, int kchunk,
            const int* __restrict__ grow, const int* __restrict__ gcol) {
  __shared__ __align__(16) float As[2][BK][kAStride];
  __shared__ __align__(16) float Bs[2][BK][BN];
  extern __shared__ __align__(16) float part[];   // [BM][BN], split > 1 only
  // the tile's row and column indices, and per-warp max/min
  __shared__ int sgr[BM], sgc[BN], sred[kThreads / 32];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  {
    // threads 0..127 load row indices, 128..255 column indices; rows past m
    // and columns past n can never be updated
    int v;
    if (tid < BM) {
      v = m0 + tid < m ? grow[m0 + tid] : INT_MIN;
      sgr[tid] = v;
    } else {
      v = n0 + tid - BM < n ? gcol[n0 + tid - BM] : INT_MAX;
      sgc[tid - BM] = v;
    }
    const int r = tid < BM ? __reduce_max_sync(0xffffffffu, v) : __reduce_min_sync(0xffffffffu, v);
    if (tid % 32 == 0) sred[tid / 32] = r;
    __syncthreads();
    const int rmax = max(max(sred[0], sred[1]), max(sred[2], sred[3]));
    const int cmin = min(min(sred[4], sred[5]), min(sred[6], sred[7]));
    // A dead tile keeps C as it is: no product, no read, no write. The S
    // blocks of a split cluster all share this output tile (the cluster
    // spans blockIdx.z only), so they are dead together and all return
    // here, before either cluster.sync(): no block waits on one that left.
    if (rmax < cmin) return;
  }
  const int split = kSplit ? gridDim.z : 1;
  const int kbeg = kSplit ? blockIdx.z * kchunk : 0, kend = kSplit ? min(k, kbeg + kchunk) : k;

  float ra[kLoads], rb[kLoads];
  auto load = [&](int k0) {
#pragma unroll
    for (int e = 0; e < kLoads; ++e) {
      const int idx = tid + e * kThreads;
      int kk, mm;
      if (x_k_major) { kk = idx / BM; mm = idx % BM; }
      else { mm = idx / BK; kk = idx % BK; }
      const int gk = k0 + kk, gm = m0 + mm;
      ra[e] = 0.f;
      if (gk < kend && gm < m)
        ra[e] = x_k_major ? x[gk * ldx + gm] : x[gm * ldx + gk];
      const int bk = idx / BN, bn = idx % BN, gbk = k0 + bk, gn = n0 + bn;
      rb[e] = (gbk < kend && gn < n) ? y[gbk * ldy + gn] : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int e = 0; e < kLoads; ++e) {
      const int idx = tid + e * kThreads;
      if (x_k_major) As[buf][idx / BM][idx % BM] = ra[e];
      else As[buf][idx % BK][idx / BK] = ra[e];
      Bs[buf][idx / BN][idx % BN] = rb[e];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;
  if (nk > 0) {
    load(kbeg);
    store(0);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) load(kbeg + (kt + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4 + 64]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * 4 + 64]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (kt + 1 < nk) store(cur ^ 1);
    __syncthreads();
  }

  const bool vec = ((reinterpret_cast<uintptr_t>(c) & 15) == 0) && (ldc % 4 == 0);
  if (!kSplit) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int gm = m0 + ty * 4 + (i & 3) + (i >> 2) * 64;
      if (gm >= m) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 v =
            make_float4(acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
        sub4_masked(c, ldc, vec, gm, n0 + tx * 4 + h * 64, n, v, sgr[gm - m0],
                    &sgc[tx * 4 + h * 64]);
      }
    }
    return;
  }

  // ---- cluster split: partial tiles meet in distributed shared memory ----
  cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty * 4 + (i & 3) + (i >> 2) * 64;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(part + r * BN + tx * 4 + h * 64) =
          make_float4(acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
  }
  cluster.sync();
  const int rows = BM / split, r0 = cluster.block_rank() * rows;
  for (int e = tid; e < rows * (BN / 4); e += kThreads) {
    const int r = r0 + e / (BN / 4), cc = (e % (BN / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < split; ++q) {
      const float4 p = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part, q) + r * BN + cc);
      v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
    }
    if (m0 + r >= m) continue;
    sub4_masked(c, ldc, vec, m0 + r, n0 + cc, n, v, sgr[r], &sgc[cc]);
  }
  cluster.sync();                          // keep each partial alive until read
}

int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

int launch(void* c, long long ldc, const void* x, long long ldx, const void* y, long long ldy,
           const int* grow, const int* gcol, int m, int n, int k, int x_k_major, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  const int tiles_n = (n + BN - 1) / BN, tiles_m = (m + BM - 1) / BM;
  // fewer output tiles than SMs: split k, doubling while the grid stays
  // within two rounds of two blocks per SM and each split keeps >= 16 k-steps
  const int tiles = tiles_m * tiles_n, sms = num_sms();
  int split = 1;
  while (tiles < sms && split < kMaxSplit && tiles * 2 * split <= 4 * sms &&
         k >= 2 * split * 16 * BK)
    split *= 2;
  const int kchunk = ((k + split - 1) / split + BK - 1) / BK * BK;
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      ksub_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSplitSmem);
  if (attr_err != cudaSuccess) return (int)attr_err;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles_n, tiles_m, split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = split > 1 ? kSplitSmem : 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  auto kernel = split > 1 ? ksub_kernel<true> : ksub_kernel<false>;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, static_cast<float*>(c), ldc,
                                     static_cast<const float*>(x), ldx,
                                     static_cast<const float*>(y), ldy, m, n, k, x_k_major,
                                     kchunk, grow, gcol);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// K6: grow (m) and gcol (n) are contiguous int32 vectors
extern "C" int dlaf_ksub_masked(void* c, long long ldc, const void* x, long long ldx,
                                const void* y, long long ldy, const void* grow,
                                const void* gcol, int m, int n, int k, int x_k_major,
                                void* stream) {
  return launch(c, ldc, x, ldx, y, ldy, static_cast<const int*>(grow),
                static_cast<const int*>(gcol), m, n, k, x_k_major, stream);
}

extern "C" const char* dlaf_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
