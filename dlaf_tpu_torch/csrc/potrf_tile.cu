// K1: Cholesky factor of one SPD tile on Hopper (sm_90a), one thread-block
// cluster.
//
// Replaces the Pallas TPU kernel dlaf_tpu/ops/pallas/potrf.py potrf_tile
// (_potrf_u_kernel, _potrf_u_kernel_blk). The TPU kernel keeps the whole
// tile in VMEM; one Hopper block has at most 227 KB of shared memory, which
// holds a whole f32 tile only up to nb = 128, while the main path factors
// leaves of nb = 512 (1 MiB of f32).
//
// What bounds it: the leaf is serial on the POTRF path (each leaf waits for
// the trailing update before it), so its latency is what counts: nb^3/3
// flops (4.5e7 at nb = 512) behind a chain of nb/32 slab steps, each a
// 32x32 diagonal factor, a triangular solve and a rank-32 update. One block
// on one SM (the first design of this kernel) ran the flops at one SM's
// FFMA rate and moved the working copy through L2 in every slab step.
//
// Design: one launch of a cluster of kCtas = 8 blocks (the portable cluster
// size) on 8 SMs. The f32 working copy W of the tile is held in the
// cluster's distributed shared memory, never in device memory: the tile's
// columns go in groups of 8 to the blocks in turn (group g to block g % 8),
// so that every block owns an equal share of each trailing triangle; at
// nb = 512 a block holds 64 columns x 512 rows (136 KB with padding) beside
// a copy of the current 32-row slab (66 KB). The factor is computed in
// upper form, A = U^T U, by slabs of kSlab = 32 rows, each step closed by
// one cluster barrier:
//   1. every block reads the slab (rows k0..k0+32, columns k0..nb) from its
//      owners into its slab copy (float4 loads through
//      cluster.map_shared_rank, 8 in flight a thread);
//   2. one warp factors the slab's 32x32 diagonal block in registers (lane
//      = column, rsqrt pivots, shuffles for the multipliers) and stores it
//      transposed;
//   3. the slab's trailing columns are finished by forward substitution
//      against that block, one column a thread (16-byte loads of the
//      transposed block, four partial sums);
//   4. every block applies the rank-32 update to its own columns of the
//      trailing upper triangle, 8x8 register tiles a thread.
// Steps 2 and 3 run in every block on the same inputs in the same order, so
// the 8 copies agree bit for bit: no block waits for an owner's solve, and
// the step needs no barrier between solve and update. An owner writes its
// columns of the finished slab back into W only after the barrier, when no
// block still reads those rows.
// The tile is read and the factor written in 16-byte vectors where the
// given triangle holds all 8 elements. What remains of the time is the
// chain of nb/32 steps: the one-warp diagonal factor, the solve, the
// gather and the update each add microseconds a step (PERF.md;
// scripts/torch_k1_breakdown.py times each part).
// Where W does not fit beside the slab copy (nb > 536), the same kernel
// keeps W in device memory (the caller's work buffer; cross-block reads
// bypass L1) and still spreads every step over the cluster; the slab copy
// bounds nb at 1808 (232,448 bytes a block on an H100).
//
// Only the given triangle of the input is read (the lower form is read
// transposed, row j of A being column j of U). A non-positive pivot gives
// rsqrt = NaN (or inf at 0), which propagates to every later entry: no
// trap, no early exit. bf16 tiles are read and written as bf16; all
// arithmetic is f32. The other triangle of the output is zero.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCtas = 8;                   // blocks of the cluster
constexpr int kThreads = 512;
constexpr int kSlab = 32;
constexpr int kGroup = 8;                  // columns per group; group g in block g % kCtas
constexpr int kPull = 8;                   // float4 loads in flight a thread
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// 8 consecutive elements as f32: one or two 16-byte loads where ``vec``
__device__ __forceinline__ void ld8(const float* p, bool vec, float* v) {
  if (vec) {
    const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w; v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = p[u];
  }
}
__device__ __forceinline__ void ld8(const __nv_bfloat16* p, bool vec, float* v) {
  if (vec) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(h[q]);
      v[2 * q] = f.x;
      v[2 * q + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = __bfloat162float(p[u]);
  }
}
// 8 consecutive elements from f32 (p 16-byte aligned)
__device__ __forceinline__ void st8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void st8(__nv_bfloat16* p, const float* v) {
  uint4 r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int q = 0; q < 4; ++q) h[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
  *reinterpret_cast<uint4*>(p) = r;
}

// groups of 8 columns a block owns (the last ones may lie past nb)
__host__ __device__ int groups_per_cta(int nb) { return (nb / kGroup + kCtas - 1) / kCtas; }
// row stride of a block's resident columns: = 4 mod 8, so that a warp
// walking one column down the rows spreads over 8 banks
__host__ __device__ int ldw(int nb) { return groups_per_cta(nb) * kGroup + 4; }
// slab copy [kSlab][nb + 4] and the pivots' rsqrt
__host__ __device__ size_t smem_global(int nb) { return 4 * (size_t(kSlab) * (nb + 4) + kSlab); }
__host__ __device__ size_t smem_resident(int nb) { return smem_global(nb) + 4 * size_t(nb) * ldw(nb); }

// global column of a block's local column lc, and the local column of j
__device__ __forceinline__ int gcol(int lc, int rank) {
  return (lc / kGroup) * (kGroup * kCtas) + rank * kGroup + lc % kGroup;
}
__device__ __forceinline__ int lcol(int j) { return (j / (kGroup * kCtas)) * kGroup + j % kGroup; }
__device__ __forceinline__ int owner(int j) { return (j / kGroup) % kCtas; }

// a: input tile (leading dim lda), only the given triangle is read; vec_in:
// a and lda allow 16-byte loads of 8 elements. out: factor (leading dim
// ldo, 16-byte aligned rows). w: f32 nb x nb work buffer (kRes: unused).
template <typename T, bool kRes>
__global__ void __launch_bounds__(kThreads, 1)
potrf_cluster_kernel(const T* __restrict__ a, long long lda, T* __restrict__ out, long long ldo,
                     float* __restrict__ w, int nb, int upper, int vec_in) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int lds = nb + 4, lw = ldw(nb), ncol = groups_per_cta(nb) * kGroup;
  float* s = smem;                           // [kSlab][lds], global column index
  float* sinv = smem + kSlab * lds;          // [kSlab]
  float* wl = sinv + kSlab;                  // [nb][lw], kRes only

  // W(i, j) of a column this block owns
  auto own = [&](int i, int j) -> float* {
    if constexpr (kRes) return wl + i * lw + lcol(j);
    else return w + (size_t)i * nb + j;
  };
  // W(i..i, j..j+3) of any column (j % 4 == 0: one group's half)
  auto any4 = [&](int i, int j) -> float4 {
    if constexpr (kRes)
      return *reinterpret_cast<const float4*>(cluster.map_shared_rank(wl, owner(j)) + i * lw + lcol(j));
    else return __ldcg(reinterpret_cast<const float4*>(w + (size_t)i * nb + j));
  };
  // the barrier that closes a phase; W in device memory is fenced first
  auto cluster_barrier = [&]() {
    if constexpr (!kRes) __threadfence();
    cluster.sync();
  };

  // ---- 0. own columns of W <- the given triangle of a, zero below -------
  // 8 elements a thread: a row of one own group (upper), or 8 rows of one
  // own column (lower: row j of a is column j of U); vector loads only
  // where all 8 lie in the given triangle
  const int ng = ncol / kGroup, nchunk = nb / kGroup;
  if (upper) {
    for (int e = tid; e < nb * ng; e += kThreads) {
      const int i = e / ng, j0 = gcol((e % ng) * kGroup, rank);
      if (j0 >= nb) continue;
      float v[8];
      if (i <= j0) {
        ld8(a + i * lda + j0, vec_in, v);
      } else {
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = i <= j0 + u ? ld(a + i * lda + j0 + u) : 0.f;
      }
      st8(own(i, j0), v);
    }
  } else {
    for (int e = tid; e < nchunk * ncol; e += kThreads) {
      const int i0 = (e / ncol) * kGroup, j = gcol(e % ncol, rank);
      if (j >= nb) continue;
      float v[8];
      if (i0 + 7 <= j) {
        ld8(a + j * lda + i0, vec_in, v);
      } else {
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = i0 + u <= j ? ld(a + j * lda + i0 + u) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) *own(i0 + u, j) = v[u];
    }
  }
  cluster_barrier();

  for (int k0 = 0;; k0 += kSlab) {
    // ---- 0'. own columns of the previous slab (rows kp..k0) into W: only
    // now, after the barrier that closed that step, may an owner overwrite
    // rows that the other blocks were still reading
    if (k0 > 0) {
      const int kp = k0 - kSlab, pwp = min(kSlab, nb - kp);
      for (int e = tid; e < pwp * ncol; e += kThreads) {
        const int r = e / ncol, c = gcol(e % ncol, rank);
        if (c < kp || c >= nb) continue;
        // the diagonal block is held transposed (step 2)
        *own(kp + r, c) = c < kp + pwp ? s[(c - kp) * lds + kp + r] : s[r * lds + c];
      }
      __syncthreads();
    }
    if (k0 >= nb) break;
    const int pw = min(kSlab, nb - k0), r0 = k0 + pw;

    // ---- 1. the slab (rows k0..r0, columns k0..nb) from its owners -------
    const int quads = (nb - k0) / 4, total = pw * quads;
    for (int e0 = tid; e0 < total; e0 += kThreads * kPull) {
      float4 v[kPull];
#pragma unroll
      for (int u = 0; u < kPull; ++u) {
        const int e = e0 + u * kThreads;
        if (e < total) v[u] = any4(k0 + e / quads, k0 + (e % quads) * 4);
      }
#pragma unroll
      for (int u = 0; u < kPull; ++u) {
        const int e = e0 + u * kThreads;
        if (e < total) *reinterpret_cast<float4*>(s + (e / quads) * lds + k0 + (e % quads) * 4) = v[u];
      }
    }
    __syncthreads();

    // ---- 2. diagonal block: one warp, lane = column k0 + lane ------------
    if (warp == 0) {
      float d[kSlab];
#pragma unroll
      for (int r = 0; r < kSlab; ++r) d[r] = (r < pw && lane < pw) ? s[r * lds + k0 + lane] : 0.f;
#pragma unroll
      for (int t = 0; t < kSlab; ++t) {
        if (t < pw) {
          const float inv = rsqrtf(__shfl_sync(kFull, d[t], t));
          if (lane == 0) sinv[t] = inv;
          d[t] *= inv;                       // row t of U; lane t: sqrt(pivot)
#pragma unroll
          for (int r = t + 1; r < kSlab; ++r) d[r] -= __shfl_sync(kFull, d[t], r) * d[t];
        }
      }
      // stored transposed: row r of the region holds column r of the
      // block, so that step 3 reads it with 16-byte loads
      __syncwarp();
#pragma unroll
      for (int r = 0; r < kSlab; ++r)
        if (r < pw && lane < pw) s[lane * lds + k0 + r] = d[r];
    }
    __syncthreads();

    // ---- 3. the slab's trailing columns: forward substitution, one column
    // a thread, four partial sums to shorten the dependent chain
    for (int c = r0 + tid; c < nb; c += kThreads) {
      float x[kSlab];
#pragma unroll
      for (int r = 0; r < kSlab; ++r) x[r] = r < pw ? s[r * lds + c] : 0.f;
#pragma unroll
      for (int r = 0; r < kSlab; ++r) {
        if (r < pw) {
          const float* dr = s + r * lds + k0;   // U[k0 + q][k0 + r], q = 0..r-1
          float part[4] = {x[r], 0.f, 0.f, 0.f};
#pragma unroll
          for (int q = 0; q + 4 <= r; q += 4) {
            const float4 d4 = *reinterpret_cast<const float4*>(dr + q);
            part[0] -= d4.x * x[q];
            part[1] -= d4.y * x[q + 1];
            part[2] -= d4.z * x[q + 2];
            part[3] -= d4.w * x[q + 3];
          }
#pragma unroll
          for (int q = r & ~3; q < r; ++q) part[q % 4] -= dr[q] * x[q];
          x[r] = ((part[0] + part[1]) + (part[2] + part[3])) * sinv[r];
        }
      }
#pragma unroll
      for (int r = 0; r < kSlab; ++r)
        if (r < pw) s[r * lds + c] = x[r];
    }
    __syncthreads();

    // ---- 4. rank-pw update of own columns of the trailing triangle ------
    // items: (row block rb, own group g) with r0/8 <= rb <= g, 8x8 each
    const int rb0 = r0 / kGroup, ngt = nb / kGroup;
    const int q0 = rb0 > rank ? (rb0 - rank + kCtas - 1) / kCtas : 0;
    int items = 0;
    for (int g = q0 * kCtas + rank; g < ngt; g += kCtas) items += g - rb0 + 1;
    for (int e = tid; e < items; e += kThreads) {
      int g = q0 * kCtas + rank, rem = e;
      while (rem >= g - rb0 + 1) {
        rem -= g - rb0 + 1;
        g += kCtas;
      }
      const int i0 = (rb0 + rem) * kGroup, j0 = g * kGroup;
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      for (int p = 0; p < pw; ++p) {
        const float4 u0 = *reinterpret_cast<const float4*>(s + p * lds + i0);
        const float4 u1 = *reinterpret_cast<const float4*>(s + p * lds + i0 + 4);
        const float4 v0 = *reinterpret_cast<const float4*>(s + p * lds + j0);
        const float4 v1 = *reinterpret_cast<const float4*>(s + p * lds + j0 + 4);
        const float ui[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
        const float vj[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ui[i], vj[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float4* row = reinterpret_cast<float4*>(own(i0 + i, j0));
        float4 lo = row[0], hi = row[1];
        lo.x -= acc[i][0]; lo.y -= acc[i][1]; lo.z -= acc[i][2]; lo.w -= acc[i][3];
        hi.x -= acc[i][4]; hi.y -= acc[i][5]; hi.z -= acc[i][6]; hi.w -= acc[i][7];
        row[0] = lo;
        row[1] = hi;
      }
    }
    // closes the step: the next slab is read from the updated W, and no
    // block leaves while another still reads its shared memory
    cluster_barrier();
  }

  // ---- 5. own columns -> output (U rows, or L columns), other triangle 0 -
  if (upper) {
    for (int e = tid; e < nb * ng; e += kThreads) {
      const int i = e / ng, j0 = gcol((e % ng) * kGroup, rank);
      if (j0 >= nb) continue;
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = i <= j0 + u ? *own(i, j0 + u) : 0.f;
      st8(out + i * ldo + j0, v);
    }
  } else {
    for (int e = tid; e < nchunk * ncol; e += kThreads) {
      const int i0 = (e / ncol) * kGroup, j = gcol(e % ncol, rank);
      if (j >= nb) continue;
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = i0 + u <= j ? *own(i0 + u, j) : 0.f;
      st8(out + j * ldo + i0, v);
    }
  }
}

int max_smem() {
  static int bytes = 0;
  if (bytes == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return bytes;
}

// the launch configuration of nb: resident or not, bytes a block; the
// kernel's shared-memory limit is raised once per instantiation
template <typename T>
cudaError_t configure(int nb, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                      const void** kernel, int* resident) {
  if (nb <= 0 || nb % kGroup || smem_global(nb) > (size_t)max_smem()) return cudaErrorInvalidValue;
  *resident = smem_resident(nb) <= (size_t)max_smem();
  *kernel = *resident ? (const void*)potrf_cluster_kernel<T, true>
                      : (const void*)potrf_cluster_kernel<T, false>;
  static const cudaError_t e_res = cudaFuncSetAttribute(
      potrf_cluster_kernel<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem());
  static const cudaError_t e_glb = cudaFuncSetAttribute(
      potrf_cluster_kernel<T, false>, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem());
  if (e_res != cudaSuccess) return e_res;
  if (e_glb != cudaSuccess) return e_glb;
  *cfg = {};
  cfg->gridDim = dim3(kCtas);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = *resident ? smem_resident(nb) : smem_global(nb);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCtas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <typename T>
cudaError_t plan(int nb, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const void* kernel;
  cudaError_t e = configure<T>(nb, &cfg, attr, &kernel, &out[0]);
  if (e != cudaSuccess) return e;
  out[1] = (int)cfg.dynamicSmemBytes;
  out[2] = kCtas;
  return cudaOccupancyMaxActiveClusters(&out[3], kernel, &cfg);
}

template <typename T>
cudaError_t launch(const void* a, long long lda, void* out, long long ldo, float* w, int nb,
                   int upper, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const void* kernel;
  int resident;
  cudaError_t e = configure<T>(nb, &cfg, attr, &kernel, &resident);
  if (e != cudaSuccess) return e;
  if (!resident && w == nullptr) return cudaErrorInvalidValue;
  cfg.stream = stream;
  const T* ap = static_cast<const T*>(a);
  T* op = static_cast<T*>(out);
  constexpr int kPer16 = 16 / sizeof(T);   // elements a 16-byte load
  if ((reinterpret_cast<uintptr_t>(out) & 15) || ldo % kPer16) return cudaErrorInvalidValue;
  const int vec_in = (reinterpret_cast<uintptr_t>(a) & 15) == 0 && lda % kPer16 == 0;
  e = resident ? cudaLaunchKernelEx(&cfg, potrf_cluster_kernel<T, true>, ap, lda, op, ldo, w, nb, upper, vec_in)
               : cudaLaunchKernelEx(&cfg, potrf_cluster_kernel<T, false>, ap, lda, op, ldo, w, nb, upper, vec_in);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// out (int[4]): W resident in the cluster (1) or in device memory (0),
// dynamic shared memory bytes a block, blocks a cluster, and the clusters of
// that shape the card can hold at once (0: it cannot be placed)
extern "C" int dlaf_potrf_tile_plan(int nb, int bf16, void* out) {
  int* o = static_cast<int*>(out);
  return (int)(bf16 ? plan<__nv_bfloat16>(nb, o) : plan<float>(nb, o));
}

// work: f32 nb x nb, used only where the plan says W is not resident
extern "C" int dlaf_potrf_tile(const void* a, long long lda, void* out, long long ldo,
                               void* work, int nb, int upper, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto w = static_cast<float*>(work);
  return (int)(bf16 ? launch<__nv_bfloat16>(a, lda, out, ldo, w, nb, upper, s)
                    : launch<float>(a, lda, out, ldo, w, nb, upper, s));
}

extern "C" const char* dlaf_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
