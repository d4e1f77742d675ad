// K3: stage-2 bulge chasing (band -> tridiagonal) on strip storage, on
// Hopper (sm_90a), f32 and complex64.
//
// Replaces the Pallas TPU kernel dlaf_tpu/ops/pallas/band2tridiag.py
// band_to_tridiag_strips_pallas (_make_kernel). It computes what
// dlaf_tpu_torch/algos/eigensolver/band_strips.py band_to_tridiag_strips
// computes: the chase of every sweep s (n-2 of them) down the band, chase c
// at reflector row i0 = s + 1 + c*b working on the window
//   G = A[[i0, i0+2b) x [i0-b, i0+b)]  =  [[CY, S], [., B]]
// with a Householder reflector H = I - tau v v^H of column y of CY (column
// b-1 for the first chase of a sweep, 0 after that), then
//   CY <- H CY (column y becomes beta e_0),  S <- H S H^H,  B <- B H^H,
// and the reflector (v with a unit head, tau) recorded at
// vs[s - sweep_lo, c], taus[s - sweep_lo, c] (sweeps outside
// [sweep_lo, sweep_lo + nrec) go to the discard row nrec).
//
// What bounds it: not flops and not bytes. A chase does ~12 b^2 flops on
// ~2.5 b^2 entries, but chases depend on each other: (s+1, c') must follow
// (s, c) where their windows overlap. The floor is the chain of dependent
// wavefront steps, ~3n of them: chase (s, c) runs at step t = 3s + c
// (band_strips.py proves the order of overlapping chases kept and the
// windows of one step disjoint), so one step holds up to ceil(ncmax/3)
// independent chases and the run is ~3n steps each as long as one chase
// plus a grid barrier.
//
// Design: one persistent cooperative launch; the blocks walk the steps
// together, with cooperative_groups' grid barrier between steps, and
// each block takes the step's lanes w = blockIdx.x, blockIdx.x + gridDim.x,
// ... (lane w holds sweep s = t/3 - w). The whole strip array is O(n b)
// (21 MB at n = 8192, b = 128, f32) and stays in the 50 MB L2, so the
// window is left in device memory and read through L2 (ld.global.cg: no
// stale L1 lines across the barrier); shared memory holds v, the
// reductions' partial sums and the window's row pointers. A chase is
//   1. y, its norm (block reduction), the reflector (one thread), v;
//   2. one read pass over CY, S (lower triangle) and B: column sums
//      w = v^H CY, q = S v (row part + column part of the stored
//      triangle), p = B v; alpha = q^H v, z = q - tau v alpha;
//   3. one update pass: CY -= tau v w, S -= tau v q^H + conj(tau) z v^H
//      (lower triangle), B -= conj(tau) p v^H.
// A warp takes rows warp, warp + 16, ... and its lanes 32 neighbouring
// columns; each lane issues the loads of RB rows of all three blocks before
// it uses any, so that L2 latency overlaps (the window never passes
// through shared memory). The symmetric form of step 3 needs S hermitian:
// its diagonal is read and written as real, as LAPACK's hermitian
// reductions keep it (an imaginary rounding residue on the diagonal would
// otherwise grow from chase to chase through alpha). Every reduction runs
// in a fixed order (warp shuffles, then the partials in warp or chunk
// order), so repeat runs are bit-identical. Complex64 is native
// interleaved complex (float2), not two real planes.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kLag = 3;       // wavefront steps between adjacent sweeps
constexpr int kMaxB = 384;    // keeps the shared-memory plan under 227 KB
constexpr int kRB = 8;        // rows whose loads a lane issues together
constexpr unsigned kFull = 0xffffffffu;

// ---- scalar arithmetic on float (real) and float2 (complex64) ----------
__device__ __forceinline__ float conj_(float a) { return a; }
__device__ __forceinline__ float2 conj_(float2 a) { return make_float2(a.x, -a.y); }
__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float2 add(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float sub(float a, float b) { return a - b; }
__device__ __forceinline__ float2 sub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float mul(float a, float b) { return a * b; }
__device__ __forceinline__ float2 mul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float abs2(float a) { return a * a; }
__device__ __forceinline__ float abs2(float2 a) { return a.x * a.x + a.y * a.y; }
__device__ __forceinline__ float div_(float a, float b) { return a / b; }
__device__ __forceinline__ float2 div_(float2 a, float2 b) {
  const float d = abs2(b);
  const float2 t = mul(a, conj_(b));
  return make_float2(t.x / d, t.y / d);
}
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ float2 zero<float2>() { return make_float2(0.f, 0.f); }
template <typename T> __device__ __forceinline__ T one();
template <> __device__ __forceinline__ float one<float>() { return 1.f; }
template <> __device__ __forceinline__ float2 one<float2>() { return make_float2(1.f, 0.f); }
__device__ __forceinline__ float realpart(float a) { return a; }
__device__ __forceinline__ float2 realpart(float2 a) { return make_float2(a.x, 0.f); }
__device__ __forceinline__ float ld(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float2 ld(const float2* p) { return __ldcg(p); }
__device__ __forceinline__ float shfl_down(float v, int o) { return __shfl_down_sync(kFull, v, o); }
__device__ __forceinline__ float2 shfl_down(float2 v, int o) {
  return make_float2(__shfl_down_sync(kFull, v.x, o), __shfl_down_sync(kFull, v.y, o));
}

// Sum over the warp, fixed tree; the result is in lane 0.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v = add(v, shfl_down(v, o));
  return v;
}

// Sum over the block: warp trees, then the warps' sums in warp order.
// red holds kWarps + 1 entries. Every thread gets the sum.
template <typename T>
__device__ T block_sum(T v, T* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    T t = red[0];
    for (int w = 1; w < kWarps; ++w) t = add(t, red[w]);
    red[kWarps] = t;
  }
  __syncthreads();
  const T r = red[kWarps];
  __syncthreads();
  return r;
}

// LAPACK larfg head: beta = -sign/phase(x0) ||y||, tau = (beta - x0)/beta,
// v = y / (x0 - beta). Where y = 0 (denominator 0): tau = 0, beta = x0,
// v = y with a unit head, as band_strips.chase_math has it.
__device__ void reflector_head(float x0, float normx, float* tau, float* beta,
                               float* denom, int* safe) {
  const float bt = -(x0 >= 0.f ? 1.f : -1.f) * normx;
  const float d = x0 - bt;
  *safe = d != 0.f;
  *tau = *safe ? (bt - x0) / bt : 0.f;
  *beta = *safe ? bt : x0;
  *denom = d;
}
__device__ void reflector_head(float2 x0, float normx, float2* tau, float2* beta,
                               float2* denom, int* safe) {
  const float mag = hypotf(x0.x, x0.y);
  const float2 phase = mag == 0.f ? make_float2(1.f, 0.f) : make_float2(x0.x / mag, x0.y / mag);
  const float2 bt = make_float2(-phase.x * normx, -phase.y * normx);
  const float2 d = sub(x0, bt);
  *safe = d.x != 0.f || d.y != 0.f;
  *tau = *safe ? div_(sub(bt, x0), bt) : zero<float2>();
  *beta = *safe ? bt : x0;
  *denom = d;
}

// Shared-memory plan of one block, in bytes from the dynamic base:
// 2b row pointers, then T arrays v, w, q, p, z (b each), the two column
// partial-sum tables (kWarps x b each), the two row partial-sum tables
// (b x ceil(b/32) each), the T reduction slots, the float reduction slots.
template <typename T>
size_t smem_bytes(int b) {
  const size_t nch = (b + 31) / 32;
  return 2 * (size_t)b * sizeof(void*) +
         ((5 + 2 * (size_t)kWarps + 2 * nch) * b + kWarps + 1) * sizeof(T) +
         (kWarps + 1) * sizeof(float);
}

template <typename T>
struct Smem {
  T** rowp;
  T *v, *w, *q, *p, *z, *part_cy, *part_s, *qp, *pp, *red;
  float* redf;
  __device__ explicit Smem(unsigned char* base, int b) {
    const int nch = (b + 31) / 32;
    rowp = reinterpret_cast<T**>(base);
    v = reinterpret_cast<T*>(base + 2 * (size_t)b * sizeof(void*));
    w = v + b;
    q = w + b;
    p = q + b;
    z = p + b;
    part_cy = z + b;
    part_s = part_cy + kWarps * b;
    qp = part_s + kWarps * b;
    pp = qp + nch * b;
    red = pp + nch * b;
    redf = reinterpret_cast<float*>(red + kWarps + 1);
  }
};

// One chase (s, c) at reflector row i0 by the whole block.
template <typename T>
__device__ void chase(T* strips, int b, long long i0, bool first, T* vrec, T* taurec,
                      const Smem<T>& sm, T& sh_tau, T& sh_beta, T& sh_denom, int& sh_safe) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nch = (b + 31) / 32;
  const long long ld5 = 5LL * b;
  // G[gr][gc] = rowp[gr][gc]: A[R, C] is at R*5b + C - (R/b)*b + 3b
  for (int g = tid; g < 2 * b; g += kThreads) {
    const long long r = i0 + g;
    sm.rowp[g] = strips + r * ld5 - (r / b) * b + 3LL * b + (i0 - b);
  }
  __syncthreads();

  // 1. the reflector of column ycol of CY
  const int ycol = first ? b - 1 : 0;
  float nrm = 0.f;
  for (int r = tid; r < b; r += kThreads) {
    const T y = ld(sm.rowp[r] + ycol);
    sm.v[r] = y;
    nrm += abs2(y);
  }
  nrm = block_sum(nrm, sm.redf);
  if (tid == 0) reflector_head(sm.v[0], sqrtf(nrm), &sh_tau, &sh_beta, &sh_denom, &sh_safe);
  __syncthreads();
  const T tau = sh_tau, beta = sh_beta, denom = sh_denom;
  const bool safe = sh_safe;
  for (int r = tid; r < b; r += kThreads) {
    const T y = sm.v[r];
    sm.v[r] = r == 0 ? one<T>() : (safe ? div_(y, denom) : y);
  }
  __syncthreads();
  for (int r = tid; r < b; r += kThreads) vrec[r] = sm.v[r];
  if (tid == 0) *taurec = tau;

  // 2. read pass: w = v^H CY and the strictly-lower part of q by columns
  //    (per-warp partials), the lower part of q and p = B v by rows
  //    (per-chunk partials)
  for (int ch = 0; ch < nch; ++ch) {
    const int c = ch * 32 + lane;
    const bool cin = c < b;
    const T vc = cin ? sm.v[c] : zero<T>();
    T acc_cy = zero<T>(), acc_s = zero<T>();
    for (int r0 = warp; r0 < b; r0 += kWarps * kRB) {
      T xcy[kRB], xs[kRB], xb[kRB];
#pragma unroll
      for (int k = 0; k < kRB; ++k) {
        const int r = r0 + k * kWarps;
        const bool in = cin && r < b;
        xcy[k] = in ? ld(sm.rowp[r] + c) : zero<T>();
        xs[k] = in && c <= r ? ld(sm.rowp[r] + b + c) : zero<T>();
        xb[k] = in ? ld(sm.rowp[b + r] + b + c) : zero<T>();
        if (c == r) xs[k] = realpart(xs[k]);
      }
#pragma unroll
      for (int k = 0; k < kRB; ++k) {
        const int r = r0 + k * kWarps;
        if (r >= b) break;                                  // warp-uniform
        const T vr = sm.v[r];
        acc_cy = add(acc_cy, mul(conj_(vr), xcy[k]));
        if (c < r) acc_s = add(acc_s, mul(conj_(xs[k]), vr));   // conj(S[r][c]) v_r -> q_c
        const T qa = warp_sum(mul(xs[k], vc));                  // S[r][c] v_c, c <= r
        const T pa = warp_sum(mul(xb[k], vc));
        if (lane == 0) {
          sm.qp[r * nch + ch] = qa;
          sm.pp[r * nch + ch] = pa;
        }
      }
    }
    if (cin) {
      sm.part_cy[warp * b + c] = acc_cy;
      sm.part_s[warp * b + c] = acc_s;
    }
  }
  __syncthreads();
  for (int c = tid; c < b; c += kThreads) {
    T ws = zero<T>(), qs = zero<T>(), ps = zero<T>();
    for (int k = 0; k < kWarps; ++k) {
      ws = add(ws, sm.part_cy[k * b + c]);
      qs = add(qs, sm.part_s[k * b + c]);
    }
    for (int k = 0; k < nch; ++k) {
      qs = add(qs, sm.qp[c * nch + k]);
      ps = add(ps, sm.pp[c * nch + k]);
    }
    sm.w[c] = ws;
    sm.q[c] = qs;
    sm.p[c] = ps;
  }
  __syncthreads();
  T al = zero<T>();
  for (int c = tid; c < b; c += kThreads) al = add(al, mul(conj_(sm.q[c]), sm.v[c]));
  al = realpart(block_sum(al, sm.red));                    // q^H v = v^H S v, real
  for (int r = tid; r < b; r += kThreads) sm.z[r] = sub(sm.q[r], mul(tau, mul(sm.v[r], al)));
  __syncthreads();

  // 3. update pass
  const T ctau = conj_(tau);
  for (int ch = 0; ch < nch; ++ch) {
    const int c = ch * 32 + lane;
    const bool cin = c < b;
    const T cvc = cin ? conj_(sm.v[c]) : zero<T>();
    const T wc = cin ? sm.w[c] : zero<T>();
    const T cqc = cin ? conj_(sm.q[c]) : zero<T>();
    for (int r0 = warp; r0 < b; r0 += kWarps * kRB) {
      T xcy[kRB], xs[kRB], xb[kRB];
#pragma unroll
      for (int k = 0; k < kRB; ++k) {
        const int r = r0 + k * kWarps;
        const bool in = cin && r < b;
        xcy[k] = in && c != ycol ? ld(sm.rowp[r] + c) : zero<T>();
        xs[k] = in && c <= r ? ld(sm.rowp[r] + b + c) : zero<T>();
        xb[k] = in ? ld(sm.rowp[b + r] + b + c) : zero<T>();
      }
#pragma unroll
      for (int k = 0; k < kRB; ++k) {
        const int r = r0 + k * kWarps;
        if (r >= b) break;                                  // warp-uniform
        if (!cin) continue;
        const T tv = mul(tau, sm.v[r]);
        T* cy = sm.rowp[r];
        cy[c] = c == ycol ? (r == 0 ? beta : zero<T>()) : sub(xcy[k], mul(tv, wc));
        T* br = sm.rowp[b + r] + b;
        br[c] = sub(xb[k], mul(mul(ctau, sm.p[r]), cvc));
        if (c <= r) {
          const T s2 = sub(sub(xs[k], mul(tv, cqc)), mul(mul(ctau, sm.z[r]), cvc));
          sm.rowp[r][b + c] = c == r ? realpart(s2) : s2;
        }
      }
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
chase_kernel(T* strips, T* vs, T* taus, int n, int b, int nrec, int sweep_lo, int nlanes,
             int tsteps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T sh_tau, sh_beta, sh_denom;
  __shared__ int sh_safe;
  const Smem<T> sm(smem_raw, b);
  cg::grid_group grid = cg::this_grid();
  const int nsweeps = n - 2, ncmax = (n + b - 2) / b;
  for (int t = 0; t < tsteps; ++t) {
    for (int w = blockIdx.x; w < nlanes; w += gridDim.x) {
      const int s = t / kLag - w;
      const int c = t - kLag * s;
      if (s < 0 || s >= nsweeps || c >= (n - 2 - s + b) / b) continue;
      const int rel = s - sweep_lo;
      const long long row = (rel >= 0 && rel < nrec) ? rel : nrec;
      chase<T>(strips, b, s + 1 + (long long)c * b, c == 0, vs + (row * ncmax + c) * b,
               taus + row * ncmax + c, sm, sh_tau, sh_beta, sh_denom, sh_safe);
    }
    grid.sync();
  }
}

int num_sms() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// The launch's shape at (n, b): the lanes (concurrent chases of the widest
// step), the grid and the dynamic shared memory. A grid barrier needs every
// block resident, so the grid is never larger than the blocks that fit on
// the card; where there are more lanes, a block takes several per step.
template <typename T>
cudaError_t plan(int n, int b, int* nlanes, int* grid, size_t* smem) {
  if (n < 3 || b < 1 || b > kMaxB) return cudaErrorInvalidValue;
  const int ncmax = (n + b - 2) / b;
  *nlanes = (ncmax - 1) / kLag + 1;
  *smem = smem_bytes<T>(b);
  auto kern = chase_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, *smem);
  if (e != cudaSuccess) return e;
  const int fit = per_sm * num_sms();
  *grid = *nlanes < fit ? *nlanes : fit;
  return *grid < 1 ? cudaErrorCooperativeLaunchTooLarge : cudaSuccess;
}

template <typename T>
int launch(void* strips, void* vs, void* taus, int n, int b, int nrec, int sweep_lo,
           cudaStream_t stream) {
  if (nrec < 0) return (int)cudaErrorInvalidValue;
  int nlanes = 0, grid = 0;
  size_t smem = 0;
  cudaError_t e = plan<T>(n, b, &nlanes, &grid, &smem);
  if (e != cudaSuccess) return (int)e;
  int tsteps = kLag * (n - 3) + 1;   // the last chase is (n-3, 0)
  auto kern = chase_kernel<T>;
  T* sp = static_cast<T*>(strips);
  T* vp = static_cast<T*>(vs);
  T* tp = static_cast<T*>(taus);
  void* args[] = {&sp, &vp, &tp, &n, &b, &nrec, &sweep_lo, &nlanes, &tsteps};
  e = cudaLaunchCooperativeKernel((const void*)kern, dim3(grid), dim3(kThreads), args,
                                  smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// strips: (>= n_strips(n, b), b, 5b), chased in place. vs: (nrec + 1, ncmax, b)
// and taus: (nrec + 1, ncmax), zero-filled by the caller (unvisited slots
// must read as tau = 0). is_complex: 0 f32, 1 complex64.
extern "C" int dlaf_band2tridiag(void* strips, void* vs, void* taus, int n, int b, int nrec,
                                 int sweep_lo, int is_complex, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_complex ? launch<float2>(strips, vs, taus, n, b, nrec, sweep_lo, st)
                    : launch<float>(strips, vs, taus, n, b, nrec, sweep_lo, st);
}

// The launch's lanes and grid at (n, b) into out[0] and out[1], without
// launching: where out[0] > out[1] a block takes several lanes per step.
extern "C" int dlaf_band2tridiag_plan(int n, int b, int is_complex, void* out) {
  int* o = static_cast<int*>(out);
  size_t smem = 0;
  return (int)(is_complex ? plan<float2>(n, b, &o[0], &o[1], &smem)
                          : plan<float>(n, b, &o[0], &o[1], &smem));
}

extern "C" const char* dlaf_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
