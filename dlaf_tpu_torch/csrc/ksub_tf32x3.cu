// K2 and K6: fused trailing updates C <- C - op(X) Y on Hopper (sm_90a), f32
// data, products on the tensor cores in three TF32 passes.
//
// K2 replaces the Pallas TPU kernel dlaf_tpu/ops/pallas/trailing.py
// ksub_matmul (_ksub_kernel); K6, the masked instantiation, replaces
// ksub_matmul_masked (_ksub_kernel_masked): the distributed POTRF's
// trailing updates, C - X Y only where grow[i] >= gcol[j] (int32 global row
// and column indices; a sentinel column index above every row index, or
// both vectors negated for the upper mask i <= j, are plain compares). As
// there, the product and the subtract share one accumulator and the product
// never reaches device memory; C is read once and written once, in place.
// The TPU kernel runs its matrix unit in three bf16 passes (hi*hi + lo*hi +
// hi*lo); this kernel runs the same split in TF32, the Hopper tensor cores'
// f32-input type.
//
// What bounds it: at the main-path shapes (up to m = n = 8192, k = 16384;
// K6's heaviest is m = 30720, n = 1536, k = 2048) this is a large GEMM. In
// f32 FFMA it is bound by 67 TFLOP/s (the first design of this kernel, an
// FFMA tile, reached 34-38); three TF32 passes on the tensor cores (495
// TFLOP/s dense on an H100 SXM) bound it at an effective 165 TFLOP/s. Only
// wgmma reaches that rate (a first design of this kernel on mma.sync
// m16n8k8 in the same tile was slower than cuBLAS's FFMA GEMM; PERF.md has
// both designs' times). The f32 operands of a 128 x 128 tile stream in
// from L2 at 32 KB a 32-deep k step, which at the tensor cores' pace is
// near the L2's rate. The deep levels of the POTRF recursion ask for small
// m x n (512 x 512, 16 output tiles) with k up to 16384, which alone would
// leave most SMs idle.
//
// The split: every f32 operand x becomes hi = rna_tf32(x) and lo =
// rna_tf32(x - hi) (x - hi is exact in f32), and each product is
// hi*hi + lo*hi + hi*lo; the dropped lo*lo and the rounding of lo leave
// about 2^-21 of |x||y| per product, f32's own level. Raw f32 is never fed
// to the tensor cores (they would truncate it to TF32: one pass, 2^-11).
// The tensor cores' f32 sums truncate, so their error grows with the
// number of additions into one accumulator (one accumulator over k = 16384
// fails K2's bound several times over: scripts/torch_chip_probes.py
// accumulation, PERF.md):
// each 32-deep k step is summed on the tensor cores from zero and then
// added into a second f32 accumulator with FFMA-pipe adds (round to
// nearest), which keeps the error at f32's level over k = 16384.
//
// Design: a 128 x 128 output tile per block of two warpgroups (256
// threads), each a 64 x 128 wgmma m64n128k8 TF32 accumulator (64 + 64
// registers a thread with the second accumulator). The operands stream
// through a ring of kStages = 4 shared-memory stages of 32-deep k steps
// filled by cp.async, 16-byte copies where the operands are 16-byte aligned
// and 4-byte copies otherwise (a template parameter: row-strided views
// with odd leading dimensions take the 4-byte path). TF32 wgmma reads B
// only K-major from shared memory, and the main path's Y (k, n) is
// N-contiguous, so each landed stage of Y is split into hi and lo and
// written transposed into K-major tiles (wgmma's no-swizzle core-matrix
// layout, 16-byte stores without bank conflicts) in one of two buffers;
// A (X, either layout) goes to the tensor cores from registers, split as
// its fragments are read. The split of tile kt runs while tile kt - 1's 12
// wgmmas are in flight.
//
// Small grids: when the output tiles cannot fill the SMs, a thread block
// cluster of S <= 8 blocks shares each output tile and splits k S ways (S
// the widest split whose clusters the card can hold in one wave). Each
// block leaves its partial tile in its own shared memory (the ring,
// drained); after a cluster barrier, block r sums its share of the tile's
// rows over all S partials through distributed shared memory, in the fixed
// order 0..S-1 (deterministic), and subtracts the sum from C.
//
// The mask (K6, kMasked): before its first copy each block loads its tile's
// slice of grow and gcol into shared memory and reduces max(grow) and
// min(gcol). A dead tile (max < min: wholly outside the mask) returns at
// once, so C is neither read nor written there and the staircase's
// conservative chunks cost only their live tiles. The S blocks of a split
// cluster share one output tile, so they are dead together and all return
// before either cluster barrier. A live tile subtracts only where the mask
// holds, in either epilogue; entries outside it are never written.
//
// K6's pipelined route (ksub_tf32x3_kernel<kMasked>): every masked
// launch with X (m, k), both operands 16-byte aligned and no k split, which
// is every K6 launch of the distributed POTRF but the small grids at the
// factorization's tail. The route above issues each k step's products only
// after its own split, the previous step's wait and promotion, and two block
// barriers, so the tensor cores idle between steps (2.5 us a 128 x 128 x 32
// step against 0.84 us at their peak). Here they are kept fed:
//   - roles swapped: the block computes D^T = Y^T X^T, a 128 (n) x 128 (m)
//     tile. X (m, k) row-major is K-major, the layout TF32 wgmma reads B in,
//     so TMA lands it as it is (128-byte rows, 128B-swizzled); Y^T is the
//     register operand A, read from Y's landed tile and split in registers.
//     D's rows take Y's columns in an order that makes those reads free of
//     bank conflicts (aoff below).
//   - warp specialization: warpgroups 0-1 run wgmma (232 registers), warp 8
//     of warpgroup 2 keeps TMA loads in flight through a ring of kRing
//     stages with full/empty mbarriers, and warps 9-11 split each landed X
//     tile into its TF32 hi (in place) and lo (beside it), one stage ahead
//     of the products, and release it through a third barrier. No
//     __syncthreads in the mainloop. The splits round on the integer pipes
//     (split_rn), not on the conversion unit.
//   - products in flight across steps: each k8 sub-step's three products
//     are one wgmma group, and the consumers wait for all but the last
//     group (wait_group 1), so the next sub-step's fragments load while the
//     tensor cores work; the step sums into one of two accumulator sets,
//     and step kt's promotion into the f32 total runs, a quarter a k8
//     sub-step, while step kt + 1's products are on the tensor cores.
//   - persistent blocks: one block a SM walks the output tiles blockIdx.x,
//     + gridDim.x, ...; tiles wholly outside the mask are found before the
//     walk and never scheduled, and one tile's epilogue overlaps the next
//     tile's loads. The epilogue stages the transposed tile through shared
//     memory, a warp's 32 rows of C at a time, so that its read-modify-write
//     of C is 16 bytes a lane in whole 32-byte sectors.
// The arithmetic is the route's above: the same split, the same three
// products a k8 step, each 32-deep step summed from zero on the tensor
// cores and added into the f32 total with round-to-nearest adds. No device
// scratch: the tensor maps are __grid_constant__ parameters.
//
// On an H100 at 700 W it holds the tensor cores at 0.55-0.61 of their TF32
// peak at the POTRF's chunks (PERF.md), drawing the card's power limit:
// the clock falls to 1.7-1.85 GHz. Its own overheads are the promotion's
// reads of the finished accumulators (about a fifth of the time) and the
// splits.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int kStages = 4;
constexpr int kLdRow = 128 + 8;            // [BK][128 + 8]: X (k, m) and Y (k, n) tiles
constexpr int kLdK = BK + 4;               // [BM][BK + 4]: X (m, k) tiles
constexpr int kATile = BM * kLdK > BK * kLdRow ? BM * kLdK : BK * kLdRow;
constexpr int kBTile = BK * kLdRow;
constexpr int kStage = kATile + kBTile;    // floats a stage
constexpr int kBt = BN * BK;               // one K-major TF32 tile of Y (hi or lo)
constexpr size_t kSmem = sizeof(float) * (kStages * kStage + 4 * kBt);
// K6 keeps its tile's row and column indices and the warps' max/min after
// the ring and the B tiles
constexpr int kIdx = BM + BN + kThreads / 32;
constexpr size_t kSmemMasked = kSmem + sizeof(int) * kIdx;
constexpr int kLdPart = BN + 4;            // a split's partial tile [BM][BN + 4]
constexpr int kMaxSplit = 8;               // portable cluster size
static_assert(BM * kLdPart <= kStages * kStage, "the partial tile reuses the ring");
static_assert(BM == 128 && BN == 128 && kThreads == 256, "two warpgroups of 64 x 128");
static_assert(kThreads == BM + BN, "K6 loads one index a thread");

template <bool kMasked>
constexpr size_t smem_bytes() { return kMasked ? kSmemMasked : kSmem; }

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// tile[r][c] <- src[(r0 + r) * ld + c0 + c] for r < R, c < C (c contiguous
// in both), zero where r0 + r >= rlim or c0 + c >= clim
template <bool kVec, int R, int C, int LD>
__device__ __forceinline__ void load_tile(float* tile, const float* src, long long ld, int r0,
                                          int rlim, int c0, int clim, int tid) {
  if constexpr (kVec) {
    constexpr int kChunks = C / 4;
#pragma unroll
    for (int e = tid; e < R * kChunks; e += kThreads) {
      const int r = e / kChunks, c = (e % kChunks) * 4, gr = r0 + r, gc = c0 + c;
      const int valid = gr < rlim ? min(max(clim - gc, 0), 4) : 0;
      cp_async16(tile + r * LD + c, valid ? src + gr * ld + gc : src, 4 * valid);
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < R * C; e += kThreads) {
      const int r = e / C, c = e % C, gr = r0 + r, gc = c0 + c;
      const bool valid = gr < rlim && gc < clim;
      cp_async4(tile + r * LD + c, valid ? src + gr * ld + gc : src, valid ? 4 : 0);
    }
  }
}

// x = hi + lo + O(2^-22 |x|), hi and lo TF32 (round to nearest, ties away)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// split() on the integer pipes, without the conversion unit, which the
// pipelined route's eight thousand splits a k step would keep busy: adding
// half a TF32 unit to the bits and clearing the 13 dropped ones is
// cvt.rna.tf32.f32's rounding (to nearest, ties away) of every finite x.
// For a NaN x that add may carry out of the sign bit and give hi = +-0, so
// lo keeps the NaN: where x is not finite, x - hi is the card's NaN
// 0x7FFFFFFF (an infinite x keeps hi = x and gets lo = NaN, as in split()),
// and lo's rounding takes the larger, as int32, of the sum and its input.
// That differs from the plain add only where the add carries into the sign
// bit, which for x - hi happens only at that NaN. Every product a non-finite
// x enters is then NaN through lo; finite values split as before.
__device__ __forceinline__ void split_rn(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  const uint32_t d = __float_as_uint(x - __uint_as_float(hi));
  lo = uint32_t(max(int(d + 0x1000u), int(d))) & 0xFFFFE000u;
}

// element (n, k) of a K-major B tile in wgmma's no-swizzle canonical layout:
// 8 x 4 core matrices of 128 contiguous bytes, K-adjacent cores 128 bytes
// apart (LBO), 8-row groups (BK / 4) * 128 bytes apart (SBO)
__device__ __forceinline__ int bt_offset(int nn, int kk) {
  return (nn / 8) * (BK / 4) * 32 + (kk / 4) * 32 + (nn % 8) * 4 + kk % 4;
}

// the descriptor of k8 step s (k = 8 s .. 8 s + 7: K cores 2 s and 2 s + 1)
__device__ __forceinline__ uint64_t bt_desc(const uint32_t* tile, int s) {
  const uint64_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(tile + s * 2 * 32));
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(128 >> 4) << 16) | (uint64_t((BK / 4) * 128 >> 4) << 32);
}

// D (64 x 128, this warpgroup) += A (64 x 8, TF32 in registers) B (8 x 128,
// TF32 in shared memory); scale_d = 0 writes D = A B
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a, uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// registers that an asynchronous wgmma reads or writes stay put until here
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void reg_fence(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// C[gm][gn..gn+3] -= v where keep[j], float4 where aligned, whole and all
// kept; entries not kept are not written
__device__ __forceinline__ void sub4(float* c, long long ldc, bool vec, int gm, int gn, int n,
                                     float4 v, const bool (&keep)[4]) {
  float* p = c + gm * ldc + gn;
  if (vec && gn + 3 < n && keep[0] && keep[1] && keep[2] && keep[3]) {
    float4 o = *reinterpret_cast<float4*>(p);
    o.x -= v.x; o.y -= v.y; o.z -= v.z; o.w -= v.w;
    *reinterpret_cast<float4*>(p) = o;
  } else {
    const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (keep[j] && gn + j < n) p[j] -= w[j];
  }
}

// kXkm: X is (k, m) (the upper-POTRF layout), else (m, k). kVec: every
// operand 16-byte aligned with leading dimensions % 4 == 0. kSplit: the
// cluster split of k (gridDim.z blocks a tile). kMasked: K6, C written only
// where grow[i] >= gcol[j] (grow and gcol unused otherwise).
template <bool kXkm, bool kVec, bool kSplit, bool kMasked>
__global__ void __launch_bounds__(kThreads, 1)
ksub_tf32x3_kernel(float* __restrict__ c, long long ldc, const float* __restrict__ x,
                   long long ldx, const float* __restrict__ y, long long ldy, int m, int n,
                   int k, int kchunk, const int* __restrict__ grow,
                   const int* __restrict__ gcol) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // K6: the tile's row and column indices (rows past m and columns past n
  // can never be updated), then the tile's liveness
  int* sgr = reinterpret_cast<int*>(smem + kStages * kStage + 4 * kBt);
  int* sgc = sgr + BM;
  if constexpr (kMasked) {
    int* sred = sgc + BN;
    int v;
    if (tid < BM) {
      v = m0 + tid < m ? grow[m0 + tid] : INT_MIN;
      sgr[tid] = v;
    } else {
      v = n0 + tid - BM < n ? gcol[n0 + tid - BM] : INT_MAX;
      sgc[tid - BM] = v;
    }
    // warps 0-3 hold rows, 4-7 columns
    const int r = tid < BM ? __reduce_max_sync(0xffffffffu, v) : __reduce_min_sync(0xffffffffu, v);
    if (lane == 0) sred[warp] = r;
    __syncthreads();
    const int rmax = max(max(sred[0], sred[1]), max(sred[2], sred[3]));
    const int cmin = min(min(sred[4], sred[5]), min(sred[6], sred[7]));
    // a dead tile keeps C as it is: no product, no read, no write; a split
    // cluster's blocks all return here together, before any cluster.sync()
    if (rmax < cmin) return;
  }
  const int kbeg = kSplit ? blockIdx.z * kchunk : 0, kend = kSplit ? min(k, kbeg + kchunk) : k;
  const int nkt = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;
  const int g = lane / 4, t = lane % 4;   // fragment row/column roles

  auto load_stage = [&](int stage, int k0) {
    float* as = smem + stage * kStage;
    float* bs = as + kATile;
    if constexpr (kXkm) load_tile<kVec, BK, BM, kLdRow>(as, x, ldx, k0, kend, m0, m, tid);
    else load_tile<kVec, BM, BK, kLdK>(as, x, ldx, m0, m, k0, kend, tid);
    load_tile<kVec, BK, BN, kLdRow>(bs, y, ldy, k0, kend, n0, n, tid);
  };

  // this warpgroup's 64 x 128 accumulators: n8 block j, fragment r at row
  // wr + g (+8 for r >= 2), column 8 j + 2 t (+1 for odd r)
  const int wr = (warp / 4) * 64 + (warp % 4) * 16;
  float acc[64], tot[64];
  uint32_t ahi[4][4], alo[4][4];   // A fragments of the 4 k8 steps in flight
#pragma unroll
  for (int i = 0; i < 64; ++i) tot[i] = acc[i] = 0.f;
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int r = 0; r < 4; ++r) ahi[s][r] = alo[s][r] = 0u;

  auto drain = [&]() {      // wait for the last tile's products, add them in
    wgmma_wait();
#pragma unroll
    for (int i = 0; i < 64; ++i) reg_fence(acc[i]);
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        reg_fence(ahi[s][r]);
        reg_fence(alo[s][r]);
      }
#pragma unroll
    for (int i = 0; i < 64; ++i) tot[i] += acc[i];
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nkt) load_stage(s, kbeg + s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();            // stage kt landed; stage kt - 1 is free
    if (kt + kStages - 1 < nkt) load_stage((kt + kStages - 1) % kStages, kbeg + (kt + kStages - 1) * BK);
    cp_async_commit();

    const float* as = smem + (kt % kStages) * kStage;
    const float* bs = as + kATile;
    // Y's tile, split into TF32 hi and lo, K-major, into this tile's buffer
    // (the other one may still feed tile kt - 1's products)
    uint32_t* bh = reinterpret_cast<uint32_t*>(smem + kStages * kStage + (kt % 2) * 2 * kBt);
    uint32_t* bl = bh + kBt;
#pragma unroll
    for (int e = tid; e < BN * (BK / 4); e += kThreads) {
      const int nn = e % BN, kq = e / BN;
      uint32_t h[4], l[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) split(bs[(kq * 4 + q) * kLdRow + nn], h[q], l[q]);
      const int off = bt_offset(nn, kq * 4);
      *reinterpret_cast<uint4*>(bh + off) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(bl + off) = make_uint4(l[0], l[1], l[2], l[3]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (kt > 0) drain();

    auto A = [&](int row, int kk) -> float {
      if constexpr (kXkm) return as[kk * kLdRow + row];
      else return as[row * kLdK + kk];
    };
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      split(A(wr + g, 8 * s + t), ahi[s][0], alo[s][0]);
      split(A(wr + g + 8, 8 * s + t), ahi[s][1], alo[s][1]);
      split(A(wr + g, 8 * s + t + 4), ahi[s][2], alo[s][2]);
      split(A(wr + g + 8, 8 * s + t + 4), ahi[s][3], alo[s][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      // the tile's first product starts its k step's sum afresh
      wgmma_tf32(acc, alo[s], bt_desc(bh, s), s > 0);
      wgmma_tf32(acc, ahi[s], bt_desc(bl, s), 1);
      wgmma_tf32(acc, ahi[s], bt_desc(bh, s), 1);
    }
    wgmma_commit();
  }
  if (nkt > 0) drain();
  cp_async_wait<0>();

  if (!kSplit) {
    const bool vec2 = ((reinterpret_cast<uintptr_t>(c) & 7) == 0) && (ldc % 2 == 0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + wr + g + h * 8;
      if (gm >= m) continue;
      const int gr = kMasked ? sgr[wr + g + h * 8] : 0;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int gn = n0 + j * 8 + 2 * t;
        float* p = c + gm * ldc + gn;
        const float v0 = tot[4 * j + 2 * h], v1 = tot[4 * j + 2 * h + 1];
        const bool k0 = !kMasked || gr >= sgc[j * 8 + 2 * t];
        const bool k1 = !kMasked || gr >= sgc[j * 8 + 2 * t + 1];
        if (vec2 && gn + 1 < n && k0 && k1) {
          float2 o = *reinterpret_cast<float2*>(p);
          o.x -= v0;
          o.y -= v1;
          *reinterpret_cast<float2*>(p) = o;
        } else {
          if (k0 && gn < n) p[0] -= v0;
          if (k1 && gn + 1 < n) p[1] -= v1;
        }
      }
    }
    return;
  }

  // ---- cluster split: partial tiles meet in distributed shared memory ----
  __syncthreads();              // every warp is done with the ring
  float* part = smem;           // [BM][kLdPart]
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<float2*>(part + (wr + g + h * 8) * kLdPart + j * 8 + 2 * t) =
          make_float2(tot[4 * j + 2 * h], tot[4 * j + 2 * h + 1]);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int split_n = gridDim.z, rows = (BM + split_n - 1) / split_n;
  const int r0 = cluster.block_rank() * rows, nrows = min(rows, BM - r0);
  const bool vec = ((reinterpret_cast<uintptr_t>(c) & 15) == 0) && (ldc % 4 == 0);
  for (int e = tid; e < nrows * (BN / 4); e += kThreads) {
    const int r = r0 + e / (BN / 4), cc = (e % (BN / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < split_n; ++q) {
      const float4 p = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, q) +
                                                        r * kLdPart + cc);
      v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
    }
    if (m0 + r >= m) continue;
    if constexpr (kMasked) {
      const int gr = sgr[r];
      const bool keep[4] = {gr >= sgc[cc], gr >= sgc[cc + 1], gr >= sgc[cc + 2], gr >= sgc[cc + 3]};
      sub4(c, ldc, vec, m0 + r, n0 + cc, n, v, keep);
    } else {
      const bool keep[4] = {true, true, true, true};
      sub4(c, ldc, vec, m0 + r, n0 + cc, n, v, keep);
    }
  }
  cluster.sync();               // keep each partial alive until read
}

// ---- K6's pipelined route ----
constexpr int kRing = 4;                   // stages of the ring
constexpr int kPThreads = 384;             // warpgroups 0-1 consumers, 2 producer
constexpr int kSplitters = 96;             // warps 9-11 split X
constexpr int kConsumerWarps = 8;
constexpr int kXBytes = BM * BK * 4;       // X: 128 rows (m) of 32 k, 128 bytes a row
constexpr int kYBox = 32 * BK * 4;         // one TMA box of Y: 32 rows (k) of 32 n
constexpr int kPStage = 3 * kXBytes;       // X (hi in place), X's lo, Y (four boxes)
constexpr int kMaxTiles = 1024;            // a block's candidate tiles (one flag each)
constexpr int kEpiLd = 16 + 4;             // a consumer warp's staged chunk [32 m][16 n + 4]
constexpr int kEpiBytes = kConsumerWarps * 32 * kEpiLd * 4;
constexpr size_t kPSmem = 1024 + kRing * kPStage + kEpiBytes + 3 * kRing * 8 + kMaxTiles;
static_assert(kYBox * 4 == kXBytes && BN == 4 * 32, "Y's tile is four 32-column boxes");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
// a box of the 2-d tensor map at (c0 inner, c1 outer) into shared memory;
// its bytes complete the barrier's transaction count
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait_n() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// a K-major B operand of 128-byte rows in the 128B swizzle (8-row groups
// 1024 bytes apart); a k8 step starts 32 bytes further into the rows
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

// the ring's barriers: full[s] (TMA landed), ready[s] (X split), empty[s]
// (the consumers are done with stage s)
struct Ring {
  uint32_t bars;   // shared address of full[0]
  __device__ __forceinline__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ __forceinline__ uint32_t ready(int s) const { return bars + 8 * (kRing + s); }
  __device__ __forceinline__ uint32_t empty(int s) const { return bars + 8 * (2 * kRing + s); }
};

// one 32-deep k step of a consumer warpgroup into cur, on the ring's stage
// of step gs; with promote, the previous step's sums (prev) are added into
// tot once its last products are done, while this step's are in flight,
// and its stage is released
__device__ __forceinline__ void pipe_step(float (&cur)[64], float (&prev)[64], float (&tot)[64],
                                          uint32_t (&ah)[2][4], uint32_t (&al)[2][4],
                                          const uint32_t (&aoff)[4], const uint8_t* smem,
                                          Ring ring, uint32_t gs, bool promote, int lane) {
  const int s = gs % kRing;
  const uint32_t par = (gs / kRing) & 1;
  mbar_wait(ring.full(s), par);
  mbar_wait(ring.ready(s), par);
  const uint8_t* st = smem + s * kPStage;
  const uint32_t xh = smem_u32(st), xl = xh + kXBytes;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t(&h)[4] = ah[j % 2];
    uint32_t(&l)[4] = al[j % 2];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_rn(*reinterpret_cast<const float*>(st + aoff[r] + j * 1024), h[r], l[r]);
    wgmma_fence();
    // as the route above: lo*hi, hi*lo, hi*hi (here Y^T X^T); the step's
    // first product starts its sum afresh
    wgmma_tf32(cur, h, sw128_desc(xl + 32 * j), j > 0);
    wgmma_tf32(cur, l, sw128_desc(xh + 32 * j), 1);
    wgmma_tf32(cur, h, sw128_desc(xh + 32 * j), 1);
    wgmma_commit();
    wgmma_wait_n<1>();
    // the group before this one is done: its fragments may be reloaded
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      reg_fence(ah[(j + 1) % 2][r]);
      reg_fence(al[(j + 1) % 2][r]);
    }
    if (promote) {
      // ... and so is the previous step: free its stage, and promote it a
      // quarter a k8 step
      if (j == 0) {
#pragma unroll
        for (int i = 0; i < 64; ++i) reg_fence(prev[i]);
        __syncwarp();
        if (lane == 0) mbar_arrive(ring.empty((gs + kRing - 1) % kRing));
      }
#pragma unroll
      for (int i = 16 * j; i < 16 * j + 16; ++i) tot[i] += prev[i];
    }
  }
}

// after a tile's last step (gs - 1): its products done, promoted, its
// stage released
__device__ __forceinline__ void pipe_finish(float (&last)[64], float (&tot)[64],
                                            uint32_t (&ah)[2][4], uint32_t (&al)[2][4],
                                            Ring ring, uint32_t gs, int lane) {
  wgmma_wait_n<0>();
#pragma unroll
  for (int i = 0; i < 64; ++i) reg_fence(last[i]);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      reg_fence(ah[j][r]);
      reg_fence(al[j][r]);
    }
#pragma unroll
  for (int i = 0; i < 64; ++i) tot[i] += last[i];
  __syncwarp();
  if (lane == 0) mbar_arrive(ring.empty((gs + kRing - 1) % kRing));
}

// tmx: X (m, k) as boxes of 32 k x 128 m; tmy: Y (k, n) as boxes of 32 n x
// 32 k; both 128B-swizzled, zero-filled past the edges. C, grow and gcol as
// in the kernel above. Only K6 takes this route (K2 keeps the one above):
// kMasked is true, the last template argument by which the profiler's
// readers tell K6's kernels from K2's.
template <bool kMasked>
__global__ void __launch_bounds__(kPThreads, 1)
ksub_tf32x3_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmy,
                   float* __restrict__ c, long long ldc, int m, int n, int k,
                   const int* __restrict__ grow, const int* __restrict__ gcol) {
  static_assert(kMasked, "K2 keeps the route above");
  extern __shared__ __align__(16) uint8_t psmem[];
  // the swizzle needs 1024-byte aligned tiles
  uint8_t* smem = psmem + (((smem_u32(psmem) + 1023) & ~1023u) - smem_u32(psmem));
  float* epi = reinterpret_cast<float*>(smem + kRing * kPStage);
  const Ring ring{smem_u32(smem + kRing * kPStage + kEpiBytes)};
  uint8_t* live = smem + kRing * kPStage + kEpiBytes + 3 * kRing * 8;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tiles_n = (n + BN - 1) / BN, tiles = ((m + BM - 1) / BM) * tiles_n;
  const int ncand = (int)blockIdx.x < tiles ? (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int nkt = (k + BK - 1) / BK;
  // candidate i of this block: the tile blockIdx.x + i gridDim.x, n fastest
  auto origin = [&](int i, int& m0, int& n0) {
    const int t = blockIdx.x + i * gridDim.x;
    m0 = (t / tiles_n) * BM;
    n0 = (t % tiles_n) * BN;
  };

  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(ring.full(s), 1);
      mbar_init(ring.ready(s), kSplitters);
      mbar_init(ring.empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // which of this block's tiles hold an entry of the mask: max(grow) over
  // the tile's rows >= min(gcol) over its columns (BM == BN: one loop)
  for (int i = warp; i < ncand; i += kPThreads / 32) {
    int m0, n0, rmax = INT_MIN, cmin = INT_MAX;
    origin(i, m0, n0);
    for (int e = lane; e < BM; e += 32) {
      if (m0 + e < m) rmax = max(rmax, grow[m0 + e]);
      if (n0 + e < n) cmin = min(cmin, gcol[n0 + e]);
    }
    const bool alive = __reduce_max_sync(0xffffffffu, rmax) >= __reduce_min_sync(0xffffffffu, cmin);
    if (lane == 0) live[i] = alive;
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // ---- producer warpgroup: its paths never rejoin the consumers' ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == kConsumerWarps) {
      if (lane != 0) return;
      uint32_t gs = 0;          // k steps issued so far, over the tiles
      for (int i = 0; i < ncand; ++i) {
        if (!live[i]) continue;
        int m0, n0;
        origin(i, m0, n0);
        const int nq = min(4, (n - n0 + 31) / 32);   // Y's boxes that hold columns
        for (int kt = 0; kt < nkt; ++kt, ++gs) {
          const int s = gs % kRing;
          const uint32_t use = gs / kRing;
          if (use > 0) mbar_wait(ring.empty(s), (use - 1) & 1);
          const uint32_t st = smem_u32(smem + s * kPStage);
          mbar_expect_tx(ring.full(s), kXBytes + nq * kYBox);
          tma_load(st, &tmx, ring.full(s), kt * BK, m0);
          for (int q = 0; q < nq; ++q)
            tma_load(st + 2 * kXBytes + q * kYBox, &tmy, ring.full(s), n0 + 32 * q, kt * BK);
        }
      }
    } else {
      // X's split in the landed layout: hi over x, lo beside it
      const int ti = tid - (kConsumerWarps + 1) * 32;
      uint32_t gs = 0;
      for (int i = 0; i < ncand; ++i) {
        if (!live[i]) continue;
        for (int kt = 0; kt < nkt; ++kt, ++gs) {
          const int s = gs % kRing;
          mbar_wait(ring.full(s), (gs / kRing) & 1);
          uint4* hi = reinterpret_cast<uint4*>(smem + s * kPStage);
          uint4* lo = hi + kXBytes / 16;
          for (int e = ti; e < kXBytes / 16; e += kSplitters) {
            const uint4 v = hi[e];
            uint4 h, l;
            split_rn(__uint_as_float(v.x), h.x, l.x);
            split_rn(__uint_as_float(v.y), h.y, l.y);
            split_rn(__uint_as_float(v.z), h.z, l.z);
            split_rn(__uint_as_float(v.w), h.w, l.w);
            hi[e] = h;
            lo[e] = l;
          }
          // the tensor cores read through the async proxy
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive(ring.ready(s));
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: D^T rows 64 w .. 64 w + 63 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int w = warp / 4, v = warp % 4, g = lane / 4, t = lane % 4;
  // D^T row 64 w + 16 v + g + 8 hh holds Y's column nloc[hh] = 32 q +
  // 16 (g / 4) + 4 (2 (v % 2) + hh) + g % 4 of the tile: box q = 2 w + v / 2,
  // 16-byte chunk 4 (g / 4) + 2 (v % 2) + hh, lane g % 4 of it. The A fragment's registers r = 0..3 read k = t + 4 (r / 2)
  // of rows hh = r % 2; under the swizzle (chunk ^ k % 8) the 32 lanes of
  // every load meet 32 banks. aoff: their bytes in the stage at k8 step 0
  // (step j is 1024 bytes further: 8 rows of 128 bytes).
  const int q = 2 * w + v / 2;
  uint32_t aoff[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kk = t + 4 * (r / 2), chunk = 4 * (g / 4) + 2 * (v % 2) + r % 2;
    aoff[r] = 2 * kXBytes + q * kYBox + kk * 128 + ((chunk ^ kk) << 4) + (g % 4) * 4;
  }

  float acc0[64], acc1[64], tot[64];
  uint32_t ah[2][4], al[2][4];   // A fragments of the two k8 steps in flight
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) ah[j][r] = al[j][r] = 0u;
  uint32_t gs = 0;   // k steps consumed so far, over the tiles

  for (int i = 0; i < ncand; ++i) {
    if (!live[i]) continue;
    int m0, n0;
    origin(i, m0, n0);
    // (the accumulators' old values are dead: the epilogue may use their registers)
#pragma unroll
    for (int e = 0; e < 64; ++e) tot[e] = acc0[e] = acc1[e] = 0.f;
    // the two accumulator sets take the steps in turn
    int kt = 0;
    for (; kt + 1 < nkt; kt += 2, gs += 2) {
      pipe_step(acc0, acc1, tot, ah, al, aoff, smem, ring, gs, kt > 0, lane);
      pipe_step(acc1, acc0, tot, ah, al, aoff, smem, ring, gs + 1, true, lane);
    }
    if (kt < nkt) {
      pipe_step(acc0, acc1, tot, ah, al, aoff, smem, ring, gs, kt > 0, lane);
      pipe_finish(acc0, tot, ah, al, ring, ++gs, lane);
    } else {
      pipe_finish(acc1, tot, ah, al, ring, gs, lane);
    }

    // epilogue: tot[4 j + 2 hh + o] is D^T (row nloc[hh], column 8 j + 2 t
    // + o), C's entry (m0 + 8 j + 2 t + o, n0 + nloc[hh]). A warp's 16
    // columns are two runs of 8 (cols0 + 0..7, cols0 + 16..23); it stages
    // its tile through shared memory in chunks of 32 rows of C, as [row][16
    // columns], and reads them back as 16-byte runs of a row, so that its
    // loads and stores of C fill whole 32-byte sectors, four columns a lane
    // (p4 = 4 (lane % 4): columns cols0 + 16 (p4 / 8) + p4 % 8 + 0..3). Kept
    // entries only; a chunk's loads are all issued before its stores.
    float* stg = epi + warp * 32 * kEpiLd;
    const int p4 = 4 * (lane % 4);
    const int gn = n0 + 32 * q + 8 * (v % 2) + 16 * (p4 / 8) + p4 % 8;
    int gc[4];
    bool cin[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      cin[i] = gn + i < n;
      gc[i] = cin[i] ? gcol[gn + i] : 0;
    }
    const bool vec = ((reinterpret_cast<uintptr_t>(c) & 15) == 0) && (ldc % 4 == 0);
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      __syncwarp();
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int o = 0; o < 2; ++o)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            stg[(8 * jj + 2 * t + o) * kEpiLd + 8 * (g / 4) + 4 * hh + g % 4] =
                tot[4 * (4 * ch + jj) + 2 * hh + o];
      __syncwarp();
      float4 dv[4], cv[4];
      bool keep[4][4], whole[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int ml = lane / 4 + 8 * r, gm = m0 + 32 * ch + ml;
        dv[r] = *reinterpret_cast<const float4*>(stg + ml * kEpiLd + p4);
        const int gr = gm < m ? grow[gm] : 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) keep[r][i] = gm < m && cin[i] && gr >= gc[i];
        whole[r] = vec && keep[r][0] && keep[r][1] && keep[r][2] && keep[r][3];
        float* pc = c + (long long)gm * ldc + gn;
        if (whole[r]) {
          cv[r] = *reinterpret_cast<const float4*>(pc);
        } else {
          cv[r] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (keep[r][0]) cv[r].x = pc[0];
          if (keep[r][1]) cv[r].y = pc[1];
          if (keep[r][2]) cv[r].z = pc[2];
          if (keep[r][3]) cv[r].w = pc[3];
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int gm = m0 + 32 * ch + lane / 4 + 8 * r;
        float* pc = c + (long long)gm * ldc + gn;
        const float4 o = make_float4(cv[r].x - dv[r].x, cv[r].y - dv[r].y, cv[r].z - dv[r].z,
                                     cv[r].w - dv[r].w);
        if (whole[r]) {
          *reinterpret_cast<float4*>(pc) = o;
        } else {
          if (keep[r][0]) pc[0] = o.x;
          if (keep[r][1]) pc[1] = o.y;
          if (keep[r][2]) pc[2] = o.z;
          if (keep[r][3]) pc[3] = o.w;
        }
      }
    }
  }
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

// clusters of s blocks (one output tile's split) the card holds at once
// (K6's few more bytes of shared memory leave one block a SM, as K2's)
int clusters_fit(int s) {
  static int fit[kMaxSplit + 1] = {};
  if (fit[s] == 0) {
    cudaFuncSetAttribute(ksub_tf32x3_kernel<true, true, true, false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(1, 1, s);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kSmem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const void* kernel = (const void*)ksub_tf32x3_kernel<true, true, true, false>;
    if (cudaOccupancyMaxActiveClusters(&fit[s], kernel, &cfg) != cudaSuccess)
      fit[s] = -1;
  }
  return fit[s];
}

// one block a SM: the widest split of k (up to 8) whose grid fits on the
// SMs in one wave, clusters included (GPC boundaries leave fewer clusters
// of 8 than SMs / 8), and whose splits keep at least 4 k steps each
int split_of(int m, int n, int k) {
  const int tiles = ((m + BM - 1) / BM) * ((n + BN - 1) / BN), sms = num_sms();
  for (int s = kMaxSplit; s > 1; --s)
    if (tiles * s <= sms && k >= s * 4 * BK && clusters_fit(s) >= tiles) return s;
  return 1;
}

template <bool kXkm, bool kVec, bool kMasked>
int launch(float* c, long long ldc, const float* x, long long ldx, const float* y, long long ldy,
           int m, int n, int k, const int* grow, const int* gcol, cudaStream_t stream) {
  const int split = split_of(m, n, k);
  const int kchunk = ((k + split - 1) / split + BK - 1) / BK * BK;
  constexpr int smem = (int)smem_bytes<kMasked>();
  static const cudaError_t attr_err[2] = {
      cudaFuncSetAttribute(ksub_tf32x3_kernel<kXkm, kVec, false, kMasked>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem),
      cudaFuncSetAttribute(ksub_tf32x3_kernel<kXkm, kVec, true, kMasked>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem)};
  if (attr_err[0] != cudaSuccess) return (int)attr_err[0];
  if (attr_err[1] != cudaSuccess) return (int)attr_err[1];

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + BN - 1) / BN, (m + BM - 1) / BM, split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  auto kernel = split > 1 ? ksub_tf32x3_kernel<kXkm, kVec, true, kMasked>
                          : ksub_tf32x3_kernel<kXkm, kVec, false, kMasked>;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, c, ldc, x, ldx, y, ldy, m, n, k, kchunk, grow,
                                     gcol);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

bool aligned16(const void* p, long long ld) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && ld % 4 == 0;
}

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda at link time)
decltype(&cuTensorMapEncodeTiled) encode_tiled() {
  static decltype(&cuTensorMapEncodeTiled) fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<decltype(&cuTensorMapEncodeTiled)>(p);
  }
  return fn;
}

// a row-major (outer, inner) f32 matrix of leading dimension ld, in boxes
// of box_outer x box_inner (box_inner * 4 = 128 bytes), 128B-swizzled
bool tensor_map(CUtensorMap* map, const float* p, long long ld, int inner, int outer,
                int box_inner, int box_outer) {
  auto encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// K6's pipelined route takes X (m, k) with both operands 16-byte aligned
// (TMA's rule) and a grid that needs no k split
bool pipelined_route(const void* x, long long ldx, const void* y, long long ldy, int m, int n,
                     int k, int x_k_major) {
  return !x_k_major && aligned16(x, ldx) && aligned16(y, ldy) && ldx >= k && ldy >= n &&
         split_of(m, n, k) == 1;
}

int launch_pipelined(float* c, long long ldc, const float* x, long long ldx, const float* y,
                     long long ldy, int m, int n, int k, const int* grow, const int* gcol,
                     cudaStream_t stream) {
  void (*kernel)(const CUtensorMap, const CUtensorMap, float*, long long, int, int, int,
                 const int*, const int*) = ksub_tf32x3_kernel<true>;
  static const cudaError_t attr_err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kPSmem);
  if (attr_err != cudaSuccess) return (int)attr_err;
  CUtensorMap tmx, tmy;
  if (!tensor_map(&tmx, x, ldx, k, m, BK, BM) || !tensor_map(&tmy, y, ldy, n, k, 32, BK))
    return (int)cudaErrorInvalidValue;
  // one block a SM, each walking its share of the tiles (at most kMaxTiles)
  const int tiles = ((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  const int grid = max(min(num_sms(), tiles), (tiles + kMaxTiles - 1) / kMaxTiles);
  kernel<<<grid, kPThreads, kPSmem, stream>>>(tmx, tmy, c, ldc, m, n, k, grow, gcol);
  return (int)cudaGetLastError();
}

// the instantiation for this layout and copy path
template <bool kMasked>
int dispatch(void* c, long long ldc, const void* x, long long ldx, const void* y, long long ldy,
             const void* grow, const void* gcol, int m, int n, int k, int x_k_major,
             void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  auto cp = static_cast<float*>(c);
  auto xp = static_cast<const float*>(x);
  auto yp = static_cast<const float*>(y);
  auto gr = static_cast<const int*>(grow);
  auto gc = static_cast<const int*>(gcol);
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(x, ldx) && aligned16(y, ldy);
  if (x_k_major)
    return vec ? launch<true, true, kMasked>(cp, ldc, xp, ldx, yp, ldy, m, n, k, gr, gc, s)
               : launch<true, false, kMasked>(cp, ldc, xp, ldx, yp, ldy, m, n, k, gr, gc, s);
  return vec ? launch<false, true, kMasked>(cp, ldc, xp, ldx, yp, ldy, m, n, k, gr, gc, s)
             : launch<false, false, kMasked>(cp, ldc, xp, ldx, yp, ldy, m, n, k, gr, gc, s);
}

}  // namespace

// K2: C (m, n) -= op(X) Y: X (k, m) with x_k_major, else (m, k); Y (k, n);
// every operand row-major with unit column stride and the leading dimension
// given
extern "C" int dlaf_ksub_tf32x3(void* c, long long ldc, const void* x, long long ldx,
                                const void* y, long long ldy, int m, int n, int k,
                                int x_k_major, void* stream) {
  return dispatch<false>(c, ldc, x, ldx, y, ldy, nullptr, nullptr, m, n, k, x_k_major, stream);
}

// K6: C (m, n) -= op(X) Y where grow[i] >= gcol[j], else C unchanged;
// operands as for K2; grow (m) and gcol (n) contiguous int32 vectors.
// *pipelined (int) is set to 1 where the call took the pipelined route, else 0
extern "C" int dlaf_ksub_tf32x3_masked(void* c, long long ldc, const void* x, long long ldx,
                                       const void* y, long long ldy, const void* grow,
                                       const void* gcol, int m, int n, int k, int x_k_major,
                                       void* stream, void* pipelined) {
  int* piped = static_cast<int*>(pipelined);
  *piped = m > 0 && n > 0 && k > 0 && pipelined_route(x, ldx, y, ldy, m, n, k, x_k_major);
  if (*piped)
    return launch_pipelined(static_cast<float*>(c), ldc, static_cast<const float*>(x), ldx,
                            static_cast<const float*>(y), ldy, m, n, k,
                            static_cast<const int*>(grow), static_cast<const int*>(gcol),
                            static_cast<cudaStream_t>(stream));
  return dispatch<true>(c, ldc, x, ldx, y, ldy, grow, gcol, m, n, k, x_k_major, stream);
}

// which copy path and split a call takes, K2's or K6's, for the checks (int[2])
extern "C" int dlaf_ksub_tf32x3_plan(const void* x, long long ldx, const void* y, long long ldy,
                                     int m, int n, int k, void* out) {
  int* o = static_cast<int*>(out);
  o[0] = aligned16(x, ldx) && aligned16(y, ldy);
  o[1] = split_of(m, n, k);
  return 0;
}

extern "C" const char* dlaf_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
