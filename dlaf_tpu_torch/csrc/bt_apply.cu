// K4 and K5: the streaming stage-4 apply of eigh_large (the stage-2
// reflectors applied to the eigenvectors), on Hopper (sm_90a), f32.
//
// Replaces the Pallas TPU kernels dlaf_tpu/ops/pallas/bt_apply.py
// bt_apply_group_pallas (K4, _make_kernel) and bt_apply_fused_pallas (K5,
// _make_fused_kernel). They compute what
// dlaf_tpu_torch/ops/kernels/bt_apply.py bt_apply_group_ref and
// bt_apply_fused_ref compute. E is the SHIFTED eigenvector buffer, seen as
// blocks of b rows (block B = rows [B b, (B+1) b)); one chase of one WY
// group is the two-block update
//   W (2b x nev) <- W - V2 (V^T W),   W = blocks (up, up + 1),
// with V (2b x b) the chase's staggered WY trapezoid and V2 = V T^H. K5
// runs k staggered groups in one pass: at step t = 0 .. nsteps-1, group
// i = 0 .. nact-1 (0 the bottom group, applied first) does its chase t on
// up = beta + nact - 1 - i + t while t < v0p + i, i ascending, so that
// each op's upper block is the next op's lower block. K4 (one group,
// ncvalid chases on blocks base + c) is K5 with k = nact = 1,
// beta = base, v0p = ncvalid.
//
// What bounds it: operations. A chase needs about 5 b^2 flops per column of
// E (V, the staggered WY trapezoid, has b nonzero rows of 2b in each
// column, V2 = V T^H about 1.5 b^2 nonzeros); this kernel multiplies the
// dense 2b x b V and V2, 8 b^2. It moves no E bytes of its own: E is read
// and written once per launch, V and V2 are read once per block. At
// n = 32768, b = 128 a whole stage 4 is 32,896 chases x 5 b^2 x 32768
// columns = 8.8e13 needed flops, 1.3 s at the card's f32 FFMA peak (the TPU
// kernel insists on HIGHEST, full f32, bt_apply.py:145-150: one bf16 pass
// cost 30x in orthogonality; so no TF32 tensor cores here either), against
// 0.16 s to read and write E once per group and 0.02 s once per 8 groups.
//
// Design:
//  - Columns are independent: every op touches all columns of E the same
//    way. So a block owns kCols = 32 columns and walks the whole step
//    sequence alone: no grid barrier, no order between blocks, and nev
//    need not be a multiple of anything (the last tile masks its columns).
//  - A carousel of k + 2 blocks of b x 32 floats in shared memory,
//    addressed by block % (k + 2): a step touches the nact + 1 blocks
//    beta + t .. beta + nact + t; the next step's fresh block is loaded
//    into registers while the step computes (its latency hides behind the
//    step's ops) and goes to its slot after them; the finished block
//    beta + t is stored after the step. The carried blocks never move.
//    At b = 128, k = 8: 10 x 16 KB plus Y (16 KB) = 176 KB.
//  - V and V2 are the same for every block and are read from L2 (256 KB a
//    chase at b = 128: one block's SM cannot hide that latency with 8
//    warps if each thread loads its operands itself). So the block streams
//    each chase's V and V2^T (V2 comes transposed, b x 2b, so that a
//    thread's rows are contiguous) through a ring of kStages chunks of
//    b^2/4 floats in shared memory with cp.async (L2 only, .cg): 8 chunks
//    of V, then 8 of V2^T, the next chunks in flight while one is used.
//    At b = 128, k = 8: 10 E blocks x 16 KB, Y 16 KB, ring 3 x 16 KB =
//    224 KB of the 227 KB a block may have.
//  - An op is two products, 2b threads. Y = V^T W (b x 32): a thread owns
//    4 rows x 4 columns, summing over 2b rows of W in order. Y goes to
//    shared memory; then W -= V2 Y: a thread owns 8 rows x 4 columns,
//    summing over b in order. Plain f32 FFMA, fixed order: repeat runs
//    are bit-identical.
// The ratio of flops to L2 bytes is 16 per byte at 32 columns (V and V2,
// 256 KB a chase, for 4.2 MFLOP): wider tiles would read the slabs less
// often but do not fit the k = 8 carousel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;          // columns of E per block
constexpr int kStages = 3;         // chunks of the V/V2^T ring
constexpr int kPieces = 8;         // chunks of V (and of V2^T) per chase
constexpr int kSmemLimit = 232448;
constexpr int kPer = kCols / 2;    // floats of a b x kCols block per thread (2b threads)

// shared memory of a launch at (k, b): k + 2 E blocks, Y, the ring
__host__ __device__ inline int smem_bytes(int k, int b) {
  return 4 * ((k + 3) * b * kCols + kStages * (b * b / 4));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
}

// block blk of E (b rows x the tile's columns) <-> registers / a slot
__device__ __forceinline__ void load_regs(const float* e, long long ld, int nev, int col0,
                                          int blk, int b, float (&regs)[kPer]) {
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int idx = threadIdx.x + m * blockDim.x;
    const int r = idx / kCols, c = idx % kCols;
    const int col = col0 + c;
    regs[m] = col < nev ? e[((long long)blk * b + r) * ld + col] : 0.f;
  }
}

__device__ __forceinline__ void regs_to_slot(float* slot, const float (&regs)[kPer]) {
#pragma unroll
  for (int m = 0; m < kPer; ++m) slot[threadIdx.x + m * blockDim.x] = regs[m];
}

__device__ __forceinline__ void load_slot(const float* e, long long ld, int nev, int col0,
                                          int blk, int b, float* slot) {
  for (int idx = threadIdx.x; idx < b * kCols; idx += blockDim.x) {
    const int r = idx / kCols, c = idx % kCols;
    const int col = col0 + c;
    slot[idx] = col < nev ? e[((long long)blk * b + r) * ld + col] : 0.f;
  }
}

__device__ __forceinline__ void store_slot(float* e, long long ld, int nev, int col0, int blk,
                                           int b, const float* slot) {
  for (int idx = threadIdx.x; idx < b * kCols; idx += blockDim.x) {
    const int r = idx / kCols, c = idx % kCols;
    const int col = col0 + c;
    if (col < nev) e[((long long)blk * b + r) * ld + col] = slot[idx];
  }
}

// The chunk stream of one step: chunk q is piece q % 16 of the step's op
// q / 16 (op o = group i_lo + o at chase t): pieces 0..7 of V, 8..15 of
// V2^T, each b^2/4 contiguous floats.
struct Stream {
  const float* v;
  const float* v2t;
  float* ring;
  long long slab;   // floats of one chase's V (or V2^T)
  int chunk;        // floats of a chunk, b^2/4
  int k, t, i_lo, nq;

  __device__ void issue(int q) const {   // start chunk q, if any; always one group
    if (q < nq) {
      const int o = q / (2 * kPieces), p = q % (2 * kPieces);
      const float* src = (p < kPieces ? v : v2t) +
                         ((long long)t * k + i_lo + o) * slab + (long long)(p % kPieces) * chunk;
      float* dst = ring + (q % kStages) * chunk;
      for (int f = 4 * threadIdx.x; f < chunk; f += 4 * blockDim.x) cp_async16(dst + f, src + f);
    }
    cp_async_commit();
  }
  // wait for chunk q, make it (and the block's earlier writes) visible,
  // start chunk q + kStages - 1 into the slot chunk q - 1 used
  __device__ const float* next(int q) const {
    cp_async_wait();
    __syncthreads();
    issue(q + kStages - 1);
    return ring + (q % kStages) * chunk;
  }
};

// One chase on W = [up; lo] (each b x kCols in shared memory), its V and
// V2^T streamed as chunks q0 .. q0+15: Y = V^T W, then W -= V2 Y.
__device__ void wy_op(float* up, float* lo, float* y, const Stream& st, int q0, int b) {
  const int tid = threadIdx.x;
  const int c0 = 4 * (tid % (kCols / 4));
  {  // Y = V^T W: rows j0 .. j0+3 of Y, columns c0 .. c0+3; a piece is b/4 rows of V
    const int j0 = 4 * (tid / (kCols / 4));
    const int rows = b / 4;
    float acc[4][4] = {};
    for (int p = 0; p < kPieces; ++p) {
      const float* vc = st.next(q0 + p) + j0;
      const int r0 = p * rows;
      const float* w = (r0 < b ? up + r0 * kCols : lo + (r0 - b) * kCols) + c0;
#pragma unroll 8
      for (int r = 0; r < rows; ++r) {
        const float4 vv = *reinterpret_cast<const float4*>(vc + r * b);
        const float4 ww = *reinterpret_cast<const float4*>(w + r * kCols);
        const float va[4] = {vv.x, vv.y, vv.z, vv.w};
        const float wa[4] = {ww.x, ww.y, ww.z, ww.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(va[a], wa[c], acc[a][c]);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
      *reinterpret_cast<float4*>(y + (j0 + a) * kCols + c0) =
          make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
  }
  {  // W -= V2 Y: rows r0 .. r0+7 of W (in one half: b % 8 == 0), columns
     // c0 .. c0+3; a piece is b/8 rows j of V2^T
    const int r0 = 8 * (tid / (kCols / 4));
    const int rows = b / 8;
    float acc[8][4] = {};
    for (int p = 0; p < kPieces; ++p) {
      const float* vc = st.next(q0 + kPieces + p) + r0;
      const float* yp = y + p * rows * kCols + c0;
#pragma unroll 4
      for (int j = 0; j < rows; ++j) {
        const float4 ya = *reinterpret_cast<const float4*>(yp + j * kCols);
        const float4 pa = *reinterpret_cast<const float4*>(vc + j * 2 * b);
        const float4 pb = *reinterpret_cast<const float4*>(vc + j * 2 * b + 4);
        const float va[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
        const float ca[4] = {ya.x, ya.y, ya.z, ya.w};
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(va[a], ca[c], acc[a][c]);
      }
    }
    float* w = r0 < b ? up + r0 * kCols : lo + (r0 - b) * kCols;
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      float4* p = reinterpret_cast<float4*>(w + a * kCols + c0);
      float4 x = *p;
      x.x -= acc[a][0];
      x.y -= acc[a][1];
      x.z -= acc[a][2];
      x.w -= acc[a][3];
      *p = x;
    }
  }
}

__global__ void __launch_bounds__(512)
bt_apply_kernel(float* e, long long ld, int nev, const float* __restrict__ v,
                const float* __restrict__ v2t, int b, int k, int beta, int nact, int v0p) {
  extern __shared__ __align__(16) float smem[];
  const int nsteps = nact > 0 ? v0p + nact - 1 : 0;
  if (nsteps <= 0) return;
  const int nslots = k + 2;
  const int blk_floats = b * kCols;
  float* y = smem + nslots * blk_floats;
  Stream st{v, v2t, y + blk_floats, 2LL * b * b, b * b / 4, k, 0, 0, 0};
  const int col0 = blockIdx.x * kCols;
  auto slot = [&](int blk) { return smem + (blk % nslots) * blk_floats; };
  // seed: the nact carried blocks and step 0's fresh block
  for (int blk = beta; blk <= beta + nact; ++blk) load_slot(e, ld, nev, col0, blk, b, slot(blk));
  float regs[kPer];
  for (int t = 0; t < nsteps; ++t) {
    const bool next = t + 1 < v0p;   // step t + 1 reads a fresh block
    if (next) load_regs(e, ld, nev, col0, beta + nact + t + 1, b, regs);
    // the step's ops: groups i_lo .. nact-1 (group i has v0p + i chases)
    st.t = t;
    st.i_lo = t >= v0p ? t - v0p + 1 : 0;
    const int nops = nact - st.i_lo;
    st.nq = nops * 2 * kPieces;
    for (int q = 0; q < kStages - 1; ++q) st.issue(q);
    for (int o = 0; o < nops; ++o) {
      const int upb = beta + nact - 1 - (st.i_lo + o) + t;
      wy_op(slot(upb), slot(upb + 1), y, st, o * 2 * kPieces, b);
    }
    __syncthreads();
    store_slot(e, ld, nev, col0, beta + t, b, slot(beta + t));
    if (next) regs_to_slot(slot(beta + nact + t + 1), regs);
  }
  __syncthreads();
  store_slot(e, ld, nev, col0, beta + nsteps, b, slot(beta + nsteps));
}

int launch(float* e, long long ld, int nev, const float* v, const float* v2t, int b, int k,
           int beta, int nact, int v0p, cudaStream_t stream) {
  if (b < 32 || b % 32 || 2 * b > 512 || k < 1 || nact < 0 || nact > k || nev < 0 ||
      beta < 0 || (nact > 0 && v0p < 1))
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(k, b);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  if (nact == 0 || nev == 0) return (int)cudaSuccess;   // no chase to run
  cudaError_t err = cudaFuncSetAttribute(bt_apply_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (nev + kCols - 1) / kCols;
  bt_apply_kernel<<<grid, 2 * b, smem, stream>>>(e, ld, nev, v, v2t, b, k, beta, nact, v0p);
  return (int)cudaGetLastError();
}

}  // namespace

// K4. e: the shifted buffer (rows of ld floats, nev used); v: (>= ncvalid,
// 2b, b); v2t: (>= ncvalid, b, 2b) = V2 transposed per chase. In place.
extern "C" int dlaf_bt_apply_group(void* e, long long ld, int nev, const void* v,
                                   const void* v2t, int b, int base, int ncvalid,
                                   void* stream) {
  return launch(static_cast<float*>(e), ld, nev, static_cast<const float*>(v),
                static_cast<const float*>(v2t), b, 1, base, ncvalid > 0 ? 1 : 0, ncvalid,
                static_cast<cudaStream_t>(stream));
}

// K5. v: (>= nsteps, k, 2b, b); v2t: (>= nsteps, k, b, 2b). In place.
extern "C" int dlaf_bt_apply_fused(void* e, long long ld, int nev, const void* v,
                                   const void* v2t, int b, int k, int beta, int nact, int v0p,
                                   void* stream) {
  return launch(static_cast<float*>(e), ld, nev, static_cast<const float*>(v),
                static_cast<const float*>(v2t), b, k, beta, nact, v0p,
                static_cast<cudaStream_t>(stream));
}

extern "C" const char* dlaf_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
