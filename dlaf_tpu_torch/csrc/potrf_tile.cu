// K1: Cholesky factor of one SPD tile on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dlaf_tpu/ops/pallas/potrf.py potrf_tile
// (_potrf_u_kernel, _potrf_u_kernel_blk). The TPU kernel keeps the whole
// tile in VMEM; a Hopper block has at most 227 KB of shared memory, which
// holds a whole f32 tile only up to nb = 128, while the main path factors
// leaves of nb = 256..1024 (1 MB of f32 at nb = 512).
//
// What bounds it: the leaf is serial on the POTRF path (each leaf waits for
// the trailing update before it), so one block on one SM does the whole
// tile; an SM's f32 FFMA rate and its L2 bandwidth bound the call.
//
// Design: an f32 working copy W of the tile stays in device memory (a 1 MB
// tile lives in the 50 MB L2). The factor is computed in upper form,
// A = U^T U, in slabs of kSlab = 32 rows:
//   1. the slab's rows (columns k0..nb) go to shared memory;
//   2. one warp factors the slab's 32x32 diagonal block in registers
//      (lane = column, rsqrt pivots, shuffles for the multipliers);
//   3. every thread finishes its own columns of the slab by forward
//      substitution against that block (no barrier inside);
//   4. the slab is written to the output (U rows, or L columns), other
//      triangle zero;
//   5. the trailing upper triangle of W takes the rank-32 update from the
//      slab in shared memory, in 8x8 register tiles per thread.
// Only the given triangle of the input is read (index arithmetic: the lower
// triangle is read transposed through a 32x33 shared-memory tile). A
// non-positive pivot gives rsqrt = NaN (or inf at 0), which propagates to
// every later entry: no trap, no early exit. bf16 tiles are read and
// written as bf16; all arithmetic is f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = kThreads / 256;   // trailing-update thread groups
constexpr int kSlab = 32;
constexpr int kTile = 128;     // trailing tile: 16 x 16 threads x 8 x 8
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__host__ __device__ size_t smem_bytes(int nb) {
  size_t slab = size_t(kSlab) * (nb + 4), tile = 32 * 33;
  return 4 * ((slab > tile ? slab : tile) + kSlab);
}

// a: input tile (leading dim lda), only the given triangle is read.
// out: factor (leading dim ldo); may alias a (a is read completely first).
// w: f32 scratch, nb x nb, contiguous.
template <typename T>
__global__ void __launch_bounds__(kThreads)
potrf_tile_kernel(const T* a, long long lda, T* out, long long ldo,
                  float* __restrict__ w, int nb, int upper) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ldS = nb + 4;                    // slab row stride (16 B aligned)
  float* s = smem;                           // [kSlab][ldS]
  float* sinv = smem + (smem_bytes(nb) / 4 - kSlab);   // rsqrt of the pivots

  // ---- 0. W's upper triangle <- the given triangle of a ------------------
  if (upper) {
    for (int i = warp; i < nb; i += kWarps)
      for (int j = i + lane; j < nb; j += 32)
        w[(size_t)i * nb + j] = ld(a + i * lda + j);
  } else {
    float* t = smem;                         // [32][33] transpose tile
    const int nt = (nb + 31) / 32;
    for (int ti = 0; ti < nt; ++ti)
      for (int tj = ti; tj < nt; ++tj) {
        for (int e = tid; e < 1024; e += kThreads) {
          const int r = e / 32, c = e % 32, gi = tj * 32 + r, gj = ti * 32 + c;
          if (gi < nb && gj < nb) t[r * 33 + c] = ld(a + gi * lda + gj);
        }
        __syncthreads();
        for (int e = tid; e < 1024; e += kThreads) {
          const int r = e / 32, c = e % 32, gi = ti * 32 + r, gj = tj * 32 + c;
          if (gi < nb && gj < nb && gi <= gj) w[(size_t)gi * nb + gj] = t[c * 33 + r];
        }
        __syncthreads();
      }
  }
  __syncthreads();

  for (int k0 = 0; k0 < nb; k0 += kSlab) {
    const int pw = min(kSlab, nb - k0);

    // ---- 1. slab rows k0..k0+pw, columns k0..nb, to shared memory --------
    for (int p = warp; p < pw; p += kWarps)
      for (int c = k0 + lane; c < nb; c += 32)
        s[p * ldS + c] = w[(size_t)(k0 + p) * nb + c];
    __syncthreads();

    // ---- 2. diagonal block: one warp, lane = column k0 + lane -----------
    if (warp == 0) {
      float d[kSlab];
#pragma unroll
      for (int r = 0; r < kSlab; ++r)
        d[r] = (r < pw && lane < pw) ? s[r * ldS + k0 + lane] : 0.f;
#pragma unroll
      for (int t = 0; t < kSlab; ++t) {
        if (t < pw) {
          const float inv = rsqrtf(__shfl_sync(kFull, d[t], t));
          if (lane == 0) sinv[t] = inv;
          d[t] *= inv;                       // row t of U; lane t: sqrt(pivot)
#pragma unroll
          for (int r = t + 1; r < kSlab; ++r)
            d[r] -= __shfl_sync(kFull, d[t], r) * d[t];
        }
      }
#pragma unroll
      for (int r = 0; r < kSlab; ++r)
        if (r < pw && lane < pw) s[r * ldS + k0 + lane] = d[r];
    }
    __syncthreads();

    // ---- 3. rest of the slab: forward substitution, one column each -----
    for (int c = k0 + pw + tid; c < nb; c += kThreads) {
      float x[kSlab];
#pragma unroll
      for (int r = 0; r < kSlab; ++r) {
        if (r < pw) {
          float v = s[r * ldS + c];
#pragma unroll
          for (int q = 0; q < r; ++q) v -= s[q * ldS + k0 + r] * x[q];
          x[r] = v * sinv[r];
          s[r * ldS + c] = x[r];
        }
      }
    }
    __syncthreads();

    // ---- 4. slab -> output, other triangle zero -------------------------
    if (upper) {
      for (int p = warp; p < pw; p += kWarps)
        for (int c = lane; c < nb; c += 32)
          st(out + (k0 + p) * ldo + c, c >= k0 + p ? s[p * ldS + c] : 0.f);
    } else {
      for (int c = warp; c < nb; c += kWarps)
        if (lane < pw)
          st(out + c * ldo + k0 + lane, c >= k0 + lane ? s[lane * ldS + c] : 0.f);
    }

    // ---- 5. trailing update of W's upper triangle (rows/cols r0..nb) ----
    // each group of 256 threads takes every kGroups-th tile of the triangle
    const int r0 = k0 + pw, m = nb - r0;
    const int grp = tid / 256, tx = tid % 16, ty = (tid % 256) / 16;
    const int ntile = (m + kTile - 1) / kTile;
    int pair = 0;
    for (int bi = 0; bi < ntile; ++bi)
      for (int bj = bi; bj < ntile; ++bj) {
        if (pair++ % kGroups != grp) continue;
        // r0 and nb are multiples of 8: a microtile is all in or all out
        const int i0 = r0 + bi * kTile + ty * 8, j0 = r0 + bj * kTile + tx * 8;
        if (i0 >= nb || j0 >= nb || i0 > j0 + 7) continue;
        float acc[8][8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
        for (int p = 0; p < pw; ++p) {
          const float4 u0 = *reinterpret_cast<const float4*>(s + p * ldS + i0);
          const float4 u1 = *reinterpret_cast<const float4*>(s + p * ldS + i0 + 4);
          const float4 v0 = *reinterpret_cast<const float4*>(s + p * ldS + j0);
          const float4 v1 = *reinterpret_cast<const float4*>(s + p * ldS + j0 + 4);
          const float ui[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
          const float vj[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ui[i], vj[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float4* row = reinterpret_cast<float4*>(w + (size_t)(i0 + i) * nb + j0);
          float4 lo = row[0], hi = row[1];
          lo.x -= acc[i][0]; lo.y -= acc[i][1]; lo.z -= acc[i][2]; lo.w -= acc[i][3];
          hi.x -= acc[i][4]; hi.y -= acc[i][5]; hi.z -= acc[i][6]; hi.w -= acc[i][7];
          row[0] = lo;
          row[1] = hi;
        }
      }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch(const void* a, long long lda, void* out, long long ldo,
                   float* w, int nb, int upper, cudaStream_t stream) {
  const size_t bytes = smem_bytes(nb);
  cudaError_t e = cudaFuncSetAttribute(potrf_tile_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e != cudaSuccess) return e;
  potrf_tile_kernel<T><<<1, kThreads, bytes, stream>>>(
      static_cast<const T*>(a), lda, static_cast<T*>(out), ldo, w, nb, upper);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dlaf_potrf_tile(const void* a, long long lda, void* out, long long ldo,
                               void* work, int nb, int upper, int bf16, void* stream) {
  if (nb <= 0 || nb % 8) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto w = static_cast<float*>(work);
  return (int)(bf16 ? launch<__nv_bfloat16>(a, lda, out, ldo, w, nb, upper, s)
                    : launch<float>(a, lda, out, ldo, w, nb, upper, s));
}

extern "C" const char* dlaf_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
