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
#include <cooperative_groups.h>
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
// operands as for K2; grow (m) and gcol (n) contiguous int32 vectors
extern "C" int dlaf_ksub_tf32x3_masked(void* c, long long ldc, const void* x, long long ldx,
                                       const void* y, long long ldy, const void* grow,
                                       const void* gcol, int m, int n, int k, int x_k_major,
                                       void* stream) {
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
