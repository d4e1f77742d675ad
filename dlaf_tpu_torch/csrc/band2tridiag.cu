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
// What bounds it: not flops and not the card's bytes. A chase does
// ~12 b^2 flops on ~2.5 b^2 entries, but chases depend on each other:
// (s+1, c') must follow (s, c) where their windows overlap. The floor is
// the chain of dependent wavefront steps, ~3n of them: chase (s, c) runs
// at step t = 3s + c (band_strips.py proves the order of overlapping
// chases kept and the windows of one step disjoint), so one step holds up
// to ceil(ncmax/3) independent chases and the run is ~3n steps, each as
// long as one chase plus the hand-over between steps. A chase runs on one
// SM, so its time is what one SM can pull from L2 and push back: on an
// H100 a window of 160 KB (b = 128, f32) arrives in about 2.4 us as bulk
// copies of its rows, 3.6 us as 16-byte loads through registers or
// cp.async, and is written back at under 40 GB/s
// (scripts/torch_chip_probes.py k3_loads); then the read pass from shared
// memory, and the hand-over (a flag through L2).
//
// Design: one persistent cooperative launch (the cooperative launch only
// guarantees that every block is resident); each block takes the lanes
// w = blockIdx.x, blockIdx.x + gridDim.x, ... (lane w holds chases
// c = 3w .. 3w+2 of sweep s = t/3 - w), in increasing order at each step.
// No grid barrier: a chase's window overlaps only the windows of lanes
// w - 1, w and w + 1 at nearby steps (overlapping chases of lanes further
// apart lie many steps apart), so lane w starts step t once lanes w - 1
// and w + 1 have finished step t - 1. Each lane counts its finished steps
// in done[w] (zeroed by the caller): a block publishes with
// __syncthreads() and st.release.gpu from one thread, and waits with
// ld.acquire.gpu, thread 0 on lane w - 1 and thread 32 on lane w + 1,
// then __syncthreads().
// ops/kernels/band2tridiag.py's schedule twin and
// tests/test_torch_k3_schedule.py check that this rule orders every pair
// of overlapping chases as the sequential chase does. No deadlock: every
// wait refers to step t - 1 only, a block takes its lanes of step t - 1
// before any of step t, and all blocks are co-resident, so by induction
// on t every lane finishes every step. The whole strip array is O(n b)
// (21 MB at n = 8192, b = 128, f32) and stays in the 50 MB L2; the window
// is read through L2 only (ld.global.cg, bulk copies: no stale L1 lines
// of what a neighbour wrote).
// Two instances of one template, chosen by the launcher from (dtype, b)
// before the launch (chase_plan returns it, chase_instance mirrors the
// rule):
//  - resident (the window fits in shared memory: f32 up to b = 128,
//    complex64 up to b = 94, b E a multiple of 4 floats): eight warps send
//    the window's 2b rows ([CY | S's lower triangle], then B) as one bulk
//    copy (cp.async.bulk, the TMA) a row, all in flight, onto one
//    mbarrier; each row's 16-byte cover lands at its own shift of 0-3
//    floats, the same for every row; meanwhile warp 0 loads column y and
//    makes the reflector. The read pass runs from shared memory as
//    per-thread dots: thread (g, i) sums entries g*L .. g*L+L-1 of
//    w_i = (v^H CY)_i, p_i = (B v)_i and q_i = (S v)_i (S hermitian from
//    its lower triangle), starting at offset i mod L and wrapping, so that
//    with row strides of 4m floats a warp's 32 threads read 32 banks both
//    in the row dots and the column dots; the G partials are summed in
//    group order. The update pass reads each entry once from shared memory
//    and writes it straight back to the strips, coalesced, a [CY | S]
//    row's two parts one after the other. Three block barriers a chase,
//    one mbarrier wait, and the hand-over's two barriers.
//  - streamed (the window does not fit: complex64 beyond b = 94, f32
//    beyond 128, or b E not a multiple of 4): the window stays in L2.
//    A chase is
//      1. y, its norm (block reduction), the reflector (one thread), v;
//      2. one read pass over CY, S (lower triangle) and B: column sums
//         w = v^H CY, q = S v (row part + column part of the stored
//         triangle), p = B v; alpha = q^H v, z = q - tau v alpha;
//      3. one update pass: CY -= tau v w, S -= tau v q^H + conj(tau) z v^H
//         (lower triangle), B -= conj(tau) p v^H.
//    A warp takes rows warp, warp + 16, ... and its lanes 32 neighbouring
//    columns; each lane issues the loads of RB rows of all three blocks
//    before it uses any, so that L2 latency overlaps.
// The symmetric form of the S update needs S hermitian: its diagonal is
// read and written as real, as LAPACK's hermitian reductions keep it (an
// imaginary rounding residue on the diagonal would otherwise grow from
// chase to chase through alpha). Every reduction runs in a fixed order
// (warp shuffles, then the partials in warp, chunk or group order), so
// repeat runs are bit-identical. Complex64 is native interleaved complex
// (float2), not two real planes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kLag = 3;       // wavefront steps between adjacent sweeps
constexpr int kMaxB = 384;    // keeps the streamed plan under 227 KB
constexpr int kRB = 8;        // rows whose loads a lane issues together (streamed)
constexpr int kResMaxB = 128; // the resident instance's widest band
constexpr int kResChunks = kResMaxB / 32;
constexpr int kCopyWarps = 2 * kResMaxB / 32;  // warps that send a resident window's rows
constexpr size_t kHeader = 64;     // the chase's scalars and the window's barrier, at the
constexpr size_t kBarrierAt = 48;  // base of shared memory
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
__device__ __forceinline__ float shfl_xor(float v, int o) { return __shfl_xor_sync(kFull, v, o); }
__device__ __forceinline__ float2 shfl_xor(float2 v, int o) {
  return make_float2(__shfl_xor_sync(kFull, v.x, o), __shfl_xor_sync(kFull, v.y, o));
}
__device__ __forceinline__ float shfl(float v, int l) { return __shfl_sync(kFull, v, l); }
__device__ __forceinline__ float2 shfl(float2 v, int l) {
  return make_float2(__shfl_sync(kFull, v.x, l), __shfl_sync(kFull, v.y, l));
}

// Sum over the warp, fixed tree; the result is in lane 0.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v = add(v, shfl_down(v, o));
  return v;
}

// Sum over the warp by butterfly: every lane gets the same bits, since each
// stage adds the same two operands in one order or the other.
template <typename T>
__device__ __forceinline__ T warp_allsum(T v) {
  for (int o = 16; o > 0; o >>= 1) v = add(v, shfl_xor(v, o));
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

// The chase's scalars, in the header of shared memory.
template <typename T>
struct Scalars {
  T tau, beta, denom;
  int safe;
};
static_assert(sizeof(Scalars<float2>) <= kBarrierAt && kBarrierAt + 8 <= kHeader,
              "header too small");

// ---- the resident window's barrier (an mbarrier the bulk copies complete) --

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void init_barrier(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(kCopyWarps)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
// Wait for the barrier's phase of this parity to complete.
__device__ __forceinline__ void wait_parity(unsigned long long* bar, unsigned parity) {
  unsigned ok = 0;
  while (!ok)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(ok) : "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// ---- the resident instance ----------------------------------------------

// Row strides in floats of the window in shared memory: a [CY | S] row of
// 2b entries and a B row of b entries, each after a shift of up to 3
// floats and with the overhang of its last 16-byte chunk, in whole chunks.
// Any multiple of 4 floats keeps the read pass free of bank conflicts,
// since thread i walks its k range rotated by i (see chase_resident).
__host__ __device__ inline int row_floats(int entries, int floats_an_entry) {
  return (entries * floats_an_entry + 6 + 3) / 4 * 4;
}
// Threads a group of the read pass (b rounded up to whole warps) and groups.
__host__ __device__ inline int res_nt(int b) { return ((b + 31) / 32) * 32; }
__host__ __device__ inline int res_groups(int b) { return kThreads / res_nt(b); }

// Shared-memory plan of the resident instance, in bytes from the dynamic
// base: the header; b rows [CY | S] and b rows B; v, w, q, p (b each); the
// read pass's partial sums (3 x groups x b).
template <typename T>
size_t resident_bytes(int b) {
  const int e = sizeof(T) / sizeof(float);
  return kHeader + (size_t)b * (row_floats(2 * b, e) + row_floats(b, e)) * sizeof(float) +
         (4 * (size_t)b + 3 * (size_t)res_groups(b) * b) * sizeof(T);
}

// One chase (s, c) at reflector row i0 by the whole block, its window in
// shared memory.
template <typename T>
__device__ void chase_resident(T* strips, int b, long long i0, bool first, T* vrec, T* taurec,
                               unsigned char* smem, unsigned& parity) {
  constexpr int E = sizeof(T) / sizeof(float);   // floats an entry
  Scalars<T>& sc = *reinterpret_cast<Scalars<T>*>(smem);
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem + kBarrierAt);
  const int LS = row_floats(2 * b, E), LB = row_floats(b, E), nt = res_nt(b), ng = res_groups(b);
  float* csf = reinterpret_cast<float*>(smem + kHeader);   // [CY | S] row r at csf + r*LS
  float* bsf = csf + b * LS;                                // B row r at bsf + r*LB
  T* v = reinterpret_cast<T*>(bsf + b * LB);
  T* w = v + b;      // w, q, p are consecutive: w + k*b is w, q, p for k = 0, 1, 2
  T* q = w + b;
  T* p = q + b;
  T* part = p + b;   // part[(k*ng + g)*b + i]: group g's partial of w, q, p (k = 0, 1, 2)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long ld5 = 5LL * b;
  const long long s0 = i0 / b;
  const int im = (int)(i0 - s0 * b);
  // window row g (0 <= g < 2b) starts at A[i0 + g, i0 - b]; A[R, C] is at
  // R*5b + C - (R/b)*b + 3b, and R/b = s0 + (g + im)/b with g + im < 3b
  auto row = [&](int g) -> T* {
    const long long strip = s0 + (g + im >= 2 * b ? 2 : (g + im >= b ? 1 : 0));
    return strips + (i0 + g) * ld5 - strip * b + 3LL * b + (i0 - b);
  };
  // every row segment of the window starts the same number of floats past
  // a 16-byte boundary (b E is a multiple of 4 floats), and sits at that
  // shift in its row of shared memory
  const int sh = (int)((reinterpret_cast<uintptr_t>(row(0)) >> 2) & 3);
  const int ldc = LS / E, ldb = LB / E;
  T* cyp = reinterpret_cast<T*>(csf + sh);           // CY[k][i] = cyp[k*ldc + i]
  T* sp = cyp + b;                                   // S[k][i] = sp[k*ldc + i]
  T* bp = reinterpret_cast<T*>(bsf + sh);            // B[k][i] = bp[k*ldb + i]
  const int ycol = first ? b - 1 : 0;

  // 1. warps 1 .. kCopyWarps send the window to shared memory as one bulk
  //    copy (TMA) a row, a row a lane, all 2b rows in flight: each row's
  //    16-byte cover ([CY | S's lower triangle], b + g + 1 entries, or B;
  //    up to 3 floats on either side land in the row's margins). Each such
  //    warp arms the barrier with its rows' bytes. Warp 0 meanwhile loads
  //    column y and makes the reflector. The proxy fence orders the strips'
  //    last writes (this block's, and through the hand-over its
  //    neighbours') before the copies read them.
  if (warp >= 1 && warp <= kCopyWarps) {
    asm volatile("fence.proxy.async.global;" ::: "memory");
    const int g = (warp - 1) * 32 + lane;
    unsigned nb = 0;
    if (g < 2 * b) {
      const T* seg = g < b ? row(g) : row(g) + b;
      nb = 16u * ((sh + (g < b ? b + g + 1 : b) * E + 3) / 4);
      const float* to = g < b ? csf + g * LS : bsf + (g - b) * LB;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
          ::"r"(smem_addr(to)), "l"(reinterpret_cast<const float*>(seg) - sh), "r"(nb),
          "r"(smem_addr(bar)) : "memory");
    }
    nb = __reduce_add_sync(kFull, nb);
    if (lane == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(smem_addr(bar)), "r"(nb) : "memory");
  }
  if (warp == 0) {
    T y[kResChunks];
    float nrm = 0.f;
#pragma unroll
    for (int k = 0; k < kResChunks; ++k) {
      const int r = lane + 32 * k;
      y[k] = r < b ? ld(row(r) + ycol) : zero<T>();
      nrm += abs2(y[k]);
    }
    nrm = warp_allsum(nrm);
    T tau, beta, denom;
    int safe;
    reflector_head(shfl(y[0], 0), sqrtf(nrm), &tau, &beta, &denom, &safe);
    const T inv = div_(one<T>(), denom);
#pragma unroll
    for (int k = 0; k < kResChunks; ++k) {
      const int r = lane + 32 * k;
      if (r < b) {
        const T vr = r == 0 ? one<T>() : (safe ? mul(y[k], inv) : y[k]);
        v[r] = vr;
        vrec[r] = vr;
      }
    }
    if (lane == 0) {
      sc.tau = tau;
      sc.beta = beta;
      *taurec = tau;
    }
  }
  wait_parity(bar, parity);
  parity ^= 1u;
  __syncthreads();

  // 2. read pass from shared memory: thread (g, i) sums k in its group's
  //    range of w_i = sum conj(v_k) CY[k][i], p_i = sum B[i][k] v_k and
  //    q_i = sum Sh[i][k] v_k, Sh[i][k] = S[i][k] (k <= i, real on the
  //    diagonal) or conj(S[k][i]) (k > i). Thread i starts its range at
  //    offset i mod its length and wraps: with a row stride of 4m floats,
  //    a warp's 32 threads then read 32 banks in the row dots as in the
  //    column dots ((4m + 1) i + const) wherever the range is 32 long.
  const int g = tid / nt, i = tid - g * nt;
  if (g < ng && i < b) {
    const int len = (b + ng - 1) / ng;
    const int k0 = min(b, g * len), nk = min(b, k0 + len) - k0;
    T aw = zero<T>(), aq = zero<T>(), ap = zero<T>();
    int kk = nk > 0 ? i % nk : 0;
    for (int jj = 0; jj < nk; ++jj) {
      const int k = k0 + kk;
      kk = kk + 1 == nk ? 0 : kk + 1;
      const T vk = v[k];
      aw = add(aw, mul(conj_(vk), cyp[k * ldc + i]));
      ap = add(ap, mul(bp[i * ldb + k], vk));
      T sk = k <= i ? sp[i * ldc + k] : conj_(sp[k * ldc + i]);
      if (k == i) sk = realpart(sk);
      aq = add(aq, mul(sk, vk));
    }
    part[g * b + i] = aw;
    part[(ng + g) * b + i] = aq;
    part[(2 * ng + g) * b + i] = ap;
  }
  __syncthreads();
  if (g < 3 && i < b) {
    const T* pk = part + g * ng * b + i;
    T acc = pk[0];
    for (int gg = 1; gg < ng; ++gg) acc = add(acc, pk[gg * b]);
    w[g * b + i] = acc;
  }
  __syncthreads();
  // alpha = q^H v (real), the same bits in every warp
  T al = zero<T>();
  for (int c = lane; c < b; c += 32) al = add(al, mul(conj_(q[c]), v[c]));
  al = realpart(warp_allsum(al));

  // 3. update pass, each window row from shared memory straight back to
  //    the strips: CY -= tau v w (column y: beta e_0) and S -= tau v q^H +
  //    conj(tau) z v^H (lower triangle) of a [CY | S] row one after the
  //    other, B -= conj(tau) p v^H
  const T tau = sc.tau, beta = sc.beta, ctau = conj_(tau);
  T wc[kResChunks], cqc[kResChunks], cvc[kResChunks];
#pragma unroll
  for (int j = 0; j < kResChunks; ++j) {
    const int c = 32 * j + lane;
    wc[j] = c < b ? w[c] : zero<T>();
    cqc[j] = c < b ? conj_(q[c]) : zero<T>();
    cvc[j] = c < b ? conj_(v[c]) : zero<T>();
  }
  for (int r = warp; r < 2 * b; r += kWarps) {
    if (r < b) {
      const T* src = cyp + r * ldc;
      T* dst = row(r);
      const T tv = mul(tau, v[r]);
      const T ctz = mul(ctau, sub(q[r], mul(tau, mul(v[r], al))));
#pragma unroll
      for (int j = 0; j < kResChunks; ++j) {
        const int c = 32 * j + lane;
        if (c < b) dst[c] = c == ycol ? (r == 0 ? beta : zero<T>()) : sub(src[c], mul(tv, wc[j]));
      }
#pragma unroll
      for (int j = 0; j < kResChunks; ++j) {
        const int c = 32 * j + lane;
        if (c <= r && c < b) {
          const T s2 = sub(sub(src[b + c], mul(tv, cqc[j])), mul(ctz, cvc[j]));
          dst[b + c] = c == r ? realpart(s2) : s2;
        }
      }
    } else {
      const T* src = bp + (r - b) * ldb;
      T* dst = row(r) + b;
      const T cp = mul(ctau, p[r - b]);
#pragma unroll
      for (int j = 0; j < kResChunks; ++j) {
        const int c = 32 * j + lane;
        if (c < b) dst[c] = sub(src[c], mul(cp, cvc[j]));
      }
    }
  }
}

// ---- the streamed instance ----------------------------------------------

// Shared-memory plan of the streamed instance, in bytes from the dynamic
// base: the header, 2b row pointers, then T arrays v, w, q, p, z (b each),
// the two column partial-sum tables (kWarps x b each), the two row
// partial-sum tables (b x ceil(b/32) each), the T reduction slots, the
// float reduction slots.
template <typename T>
size_t streamed_bytes(int b) {
  const size_t nch = (b + 31) / 32;
  return kHeader + 2 * (size_t)b * sizeof(void*) +
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
    rowp = reinterpret_cast<T**>(base + kHeader);
    v = reinterpret_cast<T*>(base + kHeader + 2 * (size_t)b * sizeof(void*));
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

// One chase (s, c) at reflector row i0 by the whole block, its window
// streamed from L2.
template <typename T>
__device__ void chase_streamed(T* strips, int b, long long i0, bool first, T* vrec, T* taurec,
                               unsigned char* smem) {
  Scalars<T>& sh = *reinterpret_cast<Scalars<T>*>(smem);
  const Smem<T> sm(smem, b);
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
  if (tid == 0) reflector_head(sm.v[0], sqrtf(nrm), &sh.tau, &sh.beta, &sh.denom, &sh.safe);
  __syncthreads();
  const T tau = sh.tau, beta = sh.beta, denom = sh.denom;
  const bool safe = sh.safe;
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
}

// ---- the launch -----------------------------------------------------------

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Lane w starts step t once lanes w - 1 and w + 1 have finished step t - 1
// (done[] counts each lane's finished steps). Thread 0 waits for lane
// w - 1 and thread 32 for lane w + 1, so that the two acquire loads' round
// trips through L2 overlap; the block barrier then passes both on.
__device__ __forceinline__ void wait_neighbours(const int* done, int w, int nlanes, int t) {
  if (threadIdx.x == 0 && w > 0)
    while (ld_acquire(done + w - 1) < t) {
    }
  if (threadIdx.x == 32 && w + 1 < nlanes)
    while (ld_acquire(done + w + 1) < t) {
    }
  __syncthreads();
}

// Lane w has finished step t: the block's writes, then the count. The
// release store orders every write of the block before it, since the block
// barrier orders them before the store (a __threadfence() before it would
// fence twice).
__device__ __forceinline__ void publish(int* done, int w, int t) {
  __syncthreads();
  if (threadIdx.x == 0) st_release(done + w, t + 1);
}

template <typename T, bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
chase_kernel(T* strips, T* vs, T* taus, int* done, int n, int b, int nrec, int sweep_lo,
             int nlanes, int tsteps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nsweeps = n - 2, ncmax = (n + b - 2) / b;
  unsigned parity = 0;   // the phase of the window's barrier the next chase completes
  if (kResident) {
    if (threadIdx.x == 0) init_barrier(reinterpret_cast<unsigned long long*>(smem + kBarrierAt));
    __syncthreads();
  }
  for (int t = 0; t < tsteps; ++t) {
    for (int w = blockIdx.x; w < nlanes; w += gridDim.x) {
      wait_neighbours(done, w, nlanes, t);
      const int s = t / kLag - w;
      const int c = t - kLag * s;
      if (s >= 0 && s < nsweeps && c < (n - 2 - s + b) / b) {
        const int rel = s - sweep_lo;
        const long long row = (rel >= 0 && rel < nrec) ? rel : nrec;
        T* vrec = vs + (row * ncmax + c) * b;
        T* taurec = taus + row * ncmax + c;
        if (kResident) {
          chase_resident<T>(strips, b, s + 1 + (long long)c * b, c == 0, vrec, taurec, smem,
                            parity);
        } else {
          chase_streamed<T>(strips, b, s + 1 + (long long)c * b, c == 0, vrec, taurec, smem);
        }
      }
      publish(done, w, t);
    }
  }
}

int device_attr(cudaDeviceAttr attr) {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, attr, dev);
  return v;
}

// The launch's plan at (n, b): the lanes (concurrent chases of the widest
// step), the grid, the instance (resident where the window fits in the
// shared memory a block may have, with b <= kResMaxB) and its dynamic
// shared memory. The blocks must be co-resident, so the grid is never
// larger than the blocks that fit on the card; where there are more lanes,
// a block takes several per step.
struct Plan {
  int lanes, grid, resident;
  size_t smem;
};

template <typename T>
bool resident_fits(int b) {
  const int e = sizeof(T) / sizeof(float);
  return b <= kResMaxB && b * e % 4 == 0 &&
         resident_bytes<T>(b) <= (size_t)device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
}

template <typename T>
cudaError_t plan(int n, int b, Plan* pl) {
  if (n < 3 || b < 1 || b > kMaxB) return cudaErrorInvalidValue;
  const int ncmax = (n + b - 2) / b;
  pl->lanes = (ncmax - 1) / kLag + 1;
  pl->resident = resident_fits<T>(b);
  pl->smem = pl->resident ? resident_bytes<T>(b) : streamed_bytes<T>(b);
  const void* kern = pl->resident ? (const void*)chase_kernel<T, true>
                                  : (const void*)chase_kernel<T, false>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)pl->smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, pl->smem);
  if (e != cudaSuccess) return e;
  const int fit = per_sm * device_attr(cudaDevAttrMultiProcessorCount);
  pl->grid = pl->lanes < fit ? pl->lanes : fit;
  return pl->grid < 1 ? cudaErrorCooperativeLaunchTooLarge : cudaSuccess;
}

template <typename T>
int launch(void* strips, void* vs, void* taus, void* done, int n, int b, int nrec, int sweep_lo,
           cudaStream_t stream) {
  if (nrec < 0) return (int)cudaErrorInvalidValue;
  Plan pl;
  cudaError_t e = plan<T>(n, b, &pl);
  if (e != cudaSuccess) return (int)e;
  int tsteps = kLag * (n - 3) + 1;   // the last chase is (n-3, 0)
  const void* kern = pl.resident ? (const void*)chase_kernel<T, true>
                                 : (const void*)chase_kernel<T, false>;
  T* sp = static_cast<T*>(strips);
  T* vp = static_cast<T*>(vs);
  T* tp = static_cast<T*>(taus);
  int* dp = static_cast<int*>(done);
  int nlanes = pl.lanes;
  void* args[] = {&sp, &vp, &tp, &dp, &n, &b, &nrec, &sweep_lo, &nlanes, &tsteps};
  e = cudaLaunchCooperativeKernel(kern, dim3(pl.grid), dim3(kThreads), args, pl.smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// strips: (>= n_strips(n, b), b, 5b), chased in place. vs: (nrec + 1, ncmax, b)
// and taus: (nrec + 1, ncmax), zero-filled by the caller (unvisited slots
// must read as tau = 0). done: int32 (lanes), zero-filled by the caller.
// is_complex: 0 f32, 1 complex64.
extern "C" int dlaf_band2tridiag(void* strips, void* vs, void* taus, void* done, int n, int b,
                                 int nrec, int sweep_lo, int is_complex, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_complex ? launch<float2>(strips, vs, taus, done, n, b, nrec, sweep_lo, st)
                    : launch<float>(strips, vs, taus, done, n, b, nrec, sweep_lo, st);
}

// The launch's plan at (n, b) into out[0..3], without launching: lanes,
// grid (where lanes > grid a block takes several lanes per step), the
// instance (1 resident, 0 streamed) and its dynamic shared memory in bytes.
extern "C" int dlaf_band2tridiag_plan(int n, int b, int is_complex, void* out) {
  int* o = static_cast<int*>(out);
  Plan pl;
  const cudaError_t e = is_complex ? plan<float2>(n, b, &pl) : plan<float>(n, b, &pl);
  if (e != cudaSuccess) return (int)e;
  o[0] = pl.lanes;
  o[1] = pl.grid;
  o[2] = pl.resident;
  o[3] = (int)pl.smem;
  return 0;
}

extern "C" const char* dlaf_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
