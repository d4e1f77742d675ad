// K4 and K5: the streaming stage-4 apply of eigh_large (the stage-2
// reflectors applied to the eigenvectors), on Hopper (sm_90a), f32 data,
// products on the tensor cores in three TF32 passes.
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
// The shape of V and V2 (bt.py _group_vt_all): column j of V holds its
// reflector in rows b-1-j .. 2b-2-j and is zero elsewhere (half of V);
// T is upper triangular, so column j of V2 mixes V's columns >= j and is
// zero below row 2b-2-j (about a quarter of V2). A chase needs 5 b^2 flops
// per column of E; the dense 2b x b pair would cost 8 b^2.
//
// What bounds it: operations. At n = 32768, b = 128 a whole stage 4 is
// 32,896 chases x 5 b^2 x 32768 columns = 8.8e13 needed flops: 1.3 s at
// the card's f32 FFMA peak (67 TFLOP/s), 0.53 s on the tensor cores in
// three TF32 passes (495 TFLOP/s over 3 passes: an effective 165), against
// 0.02 s to read and write E once per 8 groups. The TPU kernel insists on
// HIGHEST (full f32; bt_apply.py:145-152: one bf16 pass cost 30x in
// orthogonality); three TF32 passes keep f32's error level, one does not.
// Next in line is L2: V and V2 are the same for every block of columns and
// each block reads the parts it multiplies, 160 KB a chase at b = 128 for
// 32 columns of E; 2,020 chases x 1,024 blocks x 160 KB = 330 GB at the
// heaviest step of n = 32768. On an H100 this kernel is far from both:
// mma.sync fragments of 16 x 32 carry few products for the loads, splits
// and adds around them, and the chunk barriers hold every warp to the
// slowest; PERF.md has the readings (scripts/torch_chip_probes.py
// k5_levers times the kernel with parts of it left out).
//
// The split: every f32 operand x becomes hi = rna_tf32(x) and lo =
// rna_tf32(x - hi) (x - hi is exact in f32), and each product is
// lo*hi + hi*lo + hi*hi, as K2 (ksub_tf32x3.cu) computes. W changes with
// every chase and is split in registers as it is read, as are V and V2; Y
// is split once, when it is made, and kept as planes of his and los.
// The tensor cores' f32 sums truncate (K2's one-accumulator probe), and a
// chase's update feeds every later chase of its blocks, so no running
// total is kept on them: each k8 step's hi*hi is summed from zero and
// added into an f32 total with FFMA-pipe adds (round to nearest), and the
// small terms, 2^-11 below it, are summed on the tensor cores apart.
//
// Design:
//  - Columns are independent: every op touches all columns of E the same
//    way. So a block owns kCols = 32 columns and walks the whole step
//    sequence alone: no grid barrier, no order between blocks, and nev
//    need not be a multiple of anything (the last tile masks its columns).
//  - A carousel of k + 1 blocks of b x 32 floats in shared memory,
//    addressed by block % (k + 1): a step touches the nact + 1 blocks
//    beta + t .. beta + nact + t; the next step's fresh block is loaded
//    into registers while the step computes (its latency hides behind the
//    step's ops); after them the finished block beta + t is stored and the
//    fresh one takes its slot (or a free one when nact < k). The carried
//    blocks never move.
//  - V and V2 stream from L2 through a ring of kStages chunks of 32 b
//    floats in shared memory with cp.async (L2 only, .cg): 2b/32 chunks of
//    32 rows of V, then b/16 chunks of 16 rows of V2^T (V2 comes
//    transposed, b x 2b, so that a chunk is one 16-deep k stretch), the
//    next chunks in flight while one is used. At b = 128, k = 8: 9 E
//    blocks x 16 KB, Y's split 32 KB, ring 3 x 16 KB = 224 KB of the
//    227 KB a block may have, so one block a SM. The band is a template
//    parameter, so that every index folds.
//  - An op is two products on mma.sync m16n8k8 TF32, 2b threads = b/16
//    warps. Y = V^T W (b x 32): warp w owns rows 16w .. 16w+15 of Y, all 32
//    columns, over the k8 steps of W's rows where its V rows are nonzero:
//    b/8 + 2 of 2b/8. Y goes to shared memory, split. W -= V2 Y: W's 2b rows are
//    2b/16 tiles of 16; tile T needs the k8 steps s with 16T + 8s <=
//    2b - 2. Warp w owns tile w (all b/8 steps) and, for one half of the
//    columns, the pair of tiles b/16 + w/2 and 2b/16 - 1 - w/2, whose step
//    counts add up to b/8 + 2: every warp does the same work.
//  - The zero rule (kSkipZeros; bt_apply.py bt_apply_skip_rule is its
//    twin, tested on _group_vt_all's slabs): a V chunk loads only the
//    columns of the warps that have a step in it, a V2^T chunk only the
//    rows of the tiles that have a step in it; nothing outside those is
//    read or multiplied. It needs no per-chase data.
//  - Shared-memory tiles are XOR-swizzled in 8-float groups (Y's planes in
//    4-word groups) so that a fragment's loads hit every bank once; a
//    16-byte cp.async piece stays contiguous. Fixed order of sums
//    everywhere: repeat runs are bit-identical.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;          // columns of E per block
constexpr int kStages = 3;         // chunks of the V/V2^T ring
constexpr int kChunkRows = 32;     // rows of V a chunk holds (of V2^T: 16)
constexpr int kMaxBand = 192;      // 2b = 384 threads, up to 168 registers a thread
constexpr int kSmemLimit = 232448;
// false multiplies the dense 2b x b V and V2 (every chunk whole): the
// same result on _group_vt_all's slabs, for measuring what the rule saves
constexpr bool kSkipZeros = true;

// shared memory of a launch at (k, b): k + 1 E blocks, Y split (the room
// of two blocks), the ring
__host__ __device__ inline int smem_bytes(int k, int b) {
  return 4 * ((k + 3) * b * kCols + kStages * kChunkRows * b);
}

// a launch runs 2B threads (B/16 warps, one a 16-row tile); each moves
// B kCols / (2B) = kPer floats of an E block
constexpr int kPer = kCols / 2;

// ---- the zero rule: which k8 steps and which chunk parts are multiplied

// k8 steps (rows 8s .. 8s+7 of V and W) of Y = V^T W for warp w: [lo, hi]
__device__ __forceinline__ int p1_lo(int b, int w) { return kSkipZeros ? b / 8 - 2 - 2 * w : 0; }
__device__ __forceinline__ int p1_hi(int b, int w) { return kSkipZeros ? b / 4 - 1 - 2 * w : b / 4 - 1; }
// columns [c0, c1) of V that chunk p (rows 32p .. 32p+31) loads: the
// warps with a step in it
__device__ __forceinline__ void p1_cols(int b, int p, int& c0, int& c1) {
  if (!kSkipZeros) {
    c0 = 0;
    c1 = b;
    return;
  }
  const int x = b / 8 - 5 - 4 * p;               // warp w has a step in p iff w >= x / 2
  const int y = b / 4 - 1 - 4 * p;               //   ... and w <= y / 2
  c0 = 16 * (x > 0 ? (x + 1) / 2 : 0);
  c1 = 16 * (min(b / 16 - 1, y / 2) + 1);
}
// k8 steps (columns 8s .. 8s+7 of V2) of W -= V2 Y that tile T (rows
// 16T .. 16T+15 of V2 and W) needs: s < count
__device__ __forceinline__ int p2_count(int b, int tile) {
  return kSkipZeros ? min(b / 8, (2 * b - 2 - 16 * tile) / 8 + 1) : b / 8;
}
// rows [0, r1) of V2 (columns of V2^T) that chunk q (V2 columns 16q ..
// 16q+15) loads: the tiles with a step in it
__device__ __forceinline__ int p2_rows(int b, int q) { return kSkipZeros ? 2 * b - 16 * q : 2 * b; }

// ---- copies and layouts

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
}

// element (r, c) of a shared-memory tile with rows of `ld` floats; the
// 8-float group of c is XORed with r % 4
__device__ __forceinline__ int swz(int r, int c, int ld) { return r * ld + (c ^ ((r & 3) << 3)); }

// block blk of E (B rows x the tile's columns) <-> registers / a slot
template <int B>
__device__ __forceinline__ void load_regs(const float* e, long long ld, int nev, int col0,
                                          int blk, float (&regs)[kPer]) {
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int idx = threadIdx.x + m * 2 * B;
    const int r = idx / kCols, c = idx % kCols;
    regs[m] = col0 + c < nev ? e[((long long)blk * B + r) * ld + col0 + c] : 0.f;
  }
}

template <int B>
__device__ __forceinline__ void regs_to_slot(float* slot, const float (&regs)[kPer]) {
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int idx = threadIdx.x + m * 2 * B;
    slot[swz(idx / kCols, idx % kCols, kCols)] = regs[m];
  }
}

template <int B>
__device__ __forceinline__ void load_slot(const float* e, long long ld, int nev, int col0,
                                          int blk, float* slot) {
  float regs[kPer];
  load_regs<B>(e, ld, nev, col0, blk, regs);
  regs_to_slot<B>(slot, regs);
}

// each thread reads back exactly the elements regs_to_slot writes, so a
// slot may be stored and refilled with no barrier between
template <int B>
__device__ __forceinline__ void store_slot(float* e, long long ld, int nev, int col0, int blk,
                                           const float* slot) {
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int idx = threadIdx.x + m * 2 * B;
    const int r = idx / kCols, c = idx % kCols;
    if (col0 + c < nev) e[((long long)blk * B + r) * ld + col0 + c] = slot[swz(r, c, kCols)];
  }
}

// ---- the tensor-core arithmetic

// x rounded to TF32 (10 explicit mantissa bits), to nearest with ties away
// from zero, on integer pipes: (bits + 0x1000) & ~0x1FFF (trailing.py
// tf32_round computes the same)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo + O(2^-22 |x|), hi and lo TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d += a b, one m16n8k8 TF32 product
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a b in three TF32 passes: the small terms lo*hi + hi*lo summed on the
// tensor cores into `small`, the large term hi*hi of this k8 step summed
// on them from zero and added into `tot` on the FFMA pipe (round to
// nearest): the tensor cores' truncating sums then never carry a running
// total, only 8 exact products or terms 2^-11 below it
__device__ __forceinline__ void mma3(float (&small)[4], float (&tot)[4],
                                     const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2], const uint32_t (&bl)[2]) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma(small, al, bh[0], bh[1]);
  mma(small, ah, bl[0], bl[1]);
  mma(d, ah, bh[0], bh[1]);
#pragma unroll
  for (int i = 0; i < 4; ++i) tot[i] += d[i];
}

// The A fragment (16 x 8) of a tile stored k-major (row k holds m
// contiguous; swizzled rows of LD floats) at k rows k0.., columns m0..:
// fragment row m is tile column m0 + 2 (m % 8) + m / 8, so that a0 and a1
// (rows g and g + 8) are one 8-byte load; the D fragment's rows follow
// the same order: c0, c1 in row m0 + 2g, c2, c3 in row m0 + 2g + 1. With
// k0 a multiple of 8, the thread's first element is a_off(m0) past row
// k0 (the swizzle of rows k0 + t and k0 + t + 4 is t's).
template <int LD>
__device__ __forceinline__ int a_off(int m0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  return t * LD + ((m0 + 2 * g) ^ (t << 3));
}

// the split A fragment at p = row k0 + a_off(m0)
template <int LD>
__device__ __forceinline__ void load_a(const float* p, uint32_t (&ah)[4], uint32_t (&al)[4]) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  const float2 z = *reinterpret_cast<const float2*>(p + 4 * LD);
  split(x.x, ah[0], al[0]);
  split(x.y, ah[1], al[1]);
  split(z.x, ah[2], al[2]);
  split(z.y, ah[3], al[3]);
}

// The B fragment (8 x 8) of a 32-column slot (W or Y) at k rows k0..,
// columns n0..: the thread's first element is b_off(n0) past row k0 (k0 a
// multiple of 8)
__device__ __forceinline__ int b_off(int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  return t * kCols + ((n0 + g) ^ (t << 3));
}

// the split B fragment at p = row k0 + b_off(n0)
__device__ __forceinline__ void load_b(const float* p, uint32_t (&bh)[2], uint32_t (&bl)[2]) {
  split(p[0], bh[0], bl[0]);
  split(p[4 * kCols], bh[1], bl[1]);
}

// Y is split once, when it is made, into a plane of his and a plane of
// los. A plane pairs rows j and j + 4 (j % 8 < 4, pair row q = 4 (j / 8) +
// j % 4) in one 64-bit word, so that a B fragment's b0, b1 (rows k0 + t,
// k0 + t + 4) are one load, and XORs column c with 4 (q % 4), so that a
// half-warp's loads hit every bank once. ysp(q, c) is the word's index.
__device__ __forceinline__ int ysp(int q, int c) { return q * kCols + (c ^ ((q & 3) << 2)); }

// the thread's word of a B fragment at columns n0.., past pair row k0 / 2
// (k0 a multiple of 8)
__device__ __forceinline__ int ysp_off(int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  return ysp(t, n0 + g);
}

// the B fragment of Y's split at word p of the hi plane (the lo plane
// follows at + B kCols / 2 words)
template <int B>
__device__ __forceinline__ void load_b_split(const uint2* p, uint32_t (&bh)[2], uint32_t (&bl)[2]) {
  const uint2 x = p[0], z = p[B * kCols / 2];
  bh[0] = x.x;
  bh[1] = x.y;
  bl[0] = z.x;
  bl[1] = z.y;
}

// ---- the chunk stream

// columns [c0, c1) (multiples of 4) of a ROWS x LD piece of src, copied in
// 16-byte pieces to the same place of a swizzled ring slot at shared
// address dst
template <int B, int ROWS, int LD>
__device__ __forceinline__ void copy_chunk(unsigned dst, const float* src, int c0, int c1) {
  constexpr int kPR = LD / 4, kN = ROWS * kPR, kT = 2 * B;
#pragma unroll
  for (int f0 = 0; f0 < kN; f0 += kT) {
    const int f = f0 + threadIdx.x;
    const int r = f / kPR, c = 4 * (f % kPR);
    if ((kN % kT == 0 || f < kN) && c >= c0 && c < c1)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   ::"r"(dst + 4u * swz(r, c, LD)), "l"(src + r * LD + c));
  }
}

// The chunk stream of one step: chunk q is piece q % (2P) of the step's
// op q / (2P) (op o = group i_lo + o at chase t): pieces 0 .. P-1 are V's
// 32-row chunks, P .. 2P-1 V2^T's 16-row chunks, P = B/16. The step's
// chases are consecutive slabs, so V's chunks, and V2^T's, follow one
// another in memory. Chunks are issued and consumed in order through the
// ring's slots.
template <int B>
struct Stream {
  static constexpr int kP = B / 16;
  static constexpr int kChunk = kChunkRows * B;   // floats of a ring slot
  const float* v;
  const float* v2t;
  const float* ring;
  int k;
  const float* vsrc;    // the next V chunk, and V2^T chunk, to issue
  const float* v2src;
  int nq, q, p, slot_in, slot_out;

  // start step t's stream (its ops: groups i_lo .. i_lo + nops - 1)
  __device__ void start(int t, int i_lo, int nops) {
    const long long first = ((long long)t * k + i_lo) * (2LL * B * B);
    vsrc = v + first;
    v2src = v2t + first;
    nq = nops * 2 * kP;
    q = p = slot_in = slot_out = 0;
    for (int i = 0; i < kStages - 1; ++i) issue();
  }
  __device__ void issue() {   // start the next chunk, if any; always one group
    if (q < nq) {
      const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(ring)) +
                           4u * slot_in * kChunk;
      if (p < kP) {            // V rows 32p .., columns [c0, c1)
        int c0, c1;
        p1_cols(B, p, c0, c1);
        copy_chunk<B, kChunkRows, B>(dst, vsrc, c0, c1);
        vsrc += kChunk;
      } else {                 // V2^T rows 16(p - P) .., columns [0, c1)
        copy_chunk<B, kChunkRows / 2, 2 * B>(dst, v2src, 0, p2_rows(B, p - kP));
        v2src += kChunk;
      }
    }
    cp_async_commit();
    ++q;
    p = p == 2 * kP - 1 ? 0 : p + 1;
    slot_in = slot_in == kStages - 1 ? 0 : slot_in + 1;
  }
  // wait for the next chunk, make it (and the block's earlier writes)
  // visible, start the chunk kStages - 1 ahead into the slot the last one used
  __device__ const float* next() {
    cp_async_wait();
    __syncthreads();
    issue();
    const float* chunk = ring + slot_out * kChunk;
    slot_out = slot_out == kStages - 1 ? 0 : slot_out + 1;
    return chunk;
  }
};

// One chase on W = [up; lo] (each B x kCols in shared memory), its V and
// V2^T the stream's next 2P chunks: Y = V^T W, then W -= V2 Y. Warp w owns
// tile w (all 4 n8 tiles of the 32 columns) and, in the second product,
// the pair tiles ta, tb on n8 tiles np0, np0 + 1 (2 warps share a pair).
template <int B>
__device__ void wy_op(float* up, float* lo, uint2* ys, Stream<B>& st) {
  constexpr int kP = B / 16, kT = B / 16;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  {  // Y = V^T W: rows 16w .. 16w + 15 of Y
    float tot[4][4] = {}, small[4][4] = {};
    const int slo = p1_lo(B, w), shi = p1_hi(B, w);
    const int oa = a_off<B>(16 * w);
    int ob[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) ob[n] = b_off(8 * n);
    // one k8 step: rows 8s .. 8s+7 of W, rows 8 ks .. of the chunk
    auto step = [&](const float* vc, int s, int ks) {
      uint32_t ah[4], al[4];
      load_a<B>(vc + 8 * ks * B + oa, ah, al);
      const float* ws = 8 * s < B ? up + 8 * s * kCols : lo + (8 * s - B) * kCols;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        uint32_t bh[2], bl[2];
        load_b(ws + ob[n], bh, bl);
        mma3(small[n], tot[n], ah, al, bh, bl);
      }
    };
    for (int p = 0; p < kP; ++p) {
      const float* vc = st.next();
      // the tile's steps in this chunk come in pairs (slo even, shi odd)
      const int s0 = max(4 * p, slo), s1 = min(4 * p + 3, shi);
      for (int s = s0; s < s1; s += 2) {
        step(vc, s, s - 4 * p);
        step(vc, s + 1, s + 1 - 4 * p);
      }
    }
    // Y, split: columns 8n + 2t, 8n + 2t + 1 of rows j = 16w + 2g + h
    uint32_t* hp = reinterpret_cast<uint32_t*>(ys);
    uint32_t* lp = hp + B * kCols;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 16 * w + 2 * g + h;
      const int q = 4 * (j / 8) + j % 4, half = (j % 8) / 4;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          uint32_t hi, lo;
          split(tot[n][2 * h + e] + small[n][2 * h + e], hi, lo);
          const int at = 2 * ysp(q, 8 * n + 2 * t + e) + half;
          hp[at] = hi;
          lp[at] = lo;
        }
    }
  }
  {  // W -= V2 Y: the warp's tile and its pair tiles ta, tb
    const int pr = w >> 1, np0 = 2 * (w & 1);
    const int ta = kT + pr, tb = 2 * kT - 1 - pr;
    // the warp's own tile (rows < B) runs every step; the pair tiles run
    // ca and cb of them
    const int ca = p2_count(B, ta), cb = p2_count(B, tb);
    const int ow = a_off<2 * B>(16 * w), oa = a_off<2 * B>(16 * ta), obb = a_off<2 * B>(16 * tb);
    int ob[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) ob[n] = ysp_off(8 * n);
    const int op0 = ysp_off(8 * np0), op1 = ysp_off(8 * np0 + 8);
    float tot[4][4] = {}, small[4][4] = {};
    float tota[2][4] = {}, smalla[2][4] = {}, totb[2][4] = {}, smallb[2][4] = {};
    for (int q = 0; q < kP; ++q) {
      const float* vc = st.next();
      // a chunk is two k8 steps 2q, 2q+1; counts are even, so both or none
      const bool da = 2 * q < ca, db = 2 * q < cb;
#pragma unroll
      for (int ss = 0; ss < 2; ++ss) {
        const uint2* yrow = ys + 4 * (2 * q + ss) * kCols;
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int n = 0; n < 4; ++n) load_b_split<B>(yrow + ob[n], bh[n], bl[n]);
        const float* vs = vc + 8 * ss * 2 * B;
        uint32_t ah[4], al[4];
        load_a<2 * B>(vs + ow, ah, al);
#pragma unroll
        for (int n = 0; n < 4; ++n) mma3(small[n], tot[n], ah, al, bh[n], bl[n]);
        if (da || db) {
          uint32_t ph[2][2], pl[2][2];
          load_b_split<B>(yrow + op0, ph[0], pl[0]);
          load_b_split<B>(yrow + op1, ph[1], pl[1]);
          if (da) {
            load_a<2 * B>(vs + oa, ah, al);
#pragma unroll
            for (int n = 0; n < 2; ++n) mma3(smalla[n], tota[n], ah, al, ph[n], pl[n]);
          }
          if (db) {
            load_a<2 * B>(vs + obb, ah, al);
#pragma unroll
            for (int n = 0; n < 2; ++n) mma3(smallb[n], totb[n], ah, al, ph[n], pl[n]);
          }
        }
      }
    }
    // W rows r (in up below B, else in lo) minus the sums
    auto sub = [&](int r, int c, float d0, float d1) {
      float* slot = r < B ? up : lo;
      float2* p = reinterpret_cast<float2*>(slot + swz(r < B ? r : r - B, c, kCols));
      float2 x = *p;
      x.x -= d0;
      x.y -= d1;
      *p = x;
    };
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 2 * h;
#pragma unroll
      for (int n = 0; n < 4; ++n)
        sub(16 * w + 2 * g + h, 8 * n + 2 * t, tot[n][i] + small[n][i],
            tot[n][i + 1] + small[n][i + 1]);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int c = 8 * (np0 + n) + 2 * t;
        sub(16 * ta + 2 * g + h, c, tota[n][i] + smalla[n][i], tota[n][i + 1] + smalla[n][i + 1]);
        sub(16 * tb + 2 * g + h, c, totb[n][i] + smallb[n][i], totb[n][i + 1] + smallb[n][i + 1]);
      }
    }
  }
}

// one block a SM
template <int B>
__global__ void __launch_bounds__(2 * B, 1)
bt_apply_kernel(float* e, long long ld, int nev, const float* __restrict__ v,
                const float* __restrict__ v2t, int k, int beta, int nact, int v0p) {
  extern __shared__ __align__(16) float smem[];
  const int nsteps = nact > 0 ? v0p + nact - 1 : 0;
  if (nsteps <= 0) return;
  // k + 1 slots: a step holds nact + 1 <= k + 1 blocks; the next step's
  // fresh block takes the finished block's slot, or a free one
  const int nslots = k + 1;
  constexpr int kBlk = B * kCols;
  uint2* ys = reinterpret_cast<uint2*>(smem + nslots * kBlk);
  Stream<B> st{v, v2t, smem + (nslots + 2) * kBlk, k};
  const int col0 = blockIdx.x * kCols;
  auto slot = [&](int blk) { return smem + (blk % nslots) * kBlk; };
  // seed: the nact carried blocks and step 0's fresh block
  for (int blk = beta; blk <= beta + nact; ++blk) load_slot<B>(e, ld, nev, col0, blk, slot(blk));
  float regs[kPer];
  for (int t = 0; t < nsteps; ++t) {
    const bool next = t + 1 < v0p;   // step t + 1 reads a fresh block
    if (next) load_regs<B>(e, ld, nev, col0, beta + nact + t + 1, regs);
    // the step's ops: groups i_lo .. nact-1 (group i has v0p + i chases)
    const int i_lo = t >= v0p ? t - v0p + 1 : 0;
    st.start(t, i_lo, nact - i_lo);
    for (int i = i_lo; i < nact; ++i) {
      const int upb = beta + nact - 1 - i + t;
      wy_op<B>(slot(upb), slot(upb + 1), ys, st);
    }
    __syncthreads();
    store_slot<B>(e, ld, nev, col0, beta + t, slot(beta + t));
    if (next) regs_to_slot<B>(slot(beta + nact + t + 1), regs);
  }
  __syncthreads();
  store_slot<B>(e, ld, nev, col0, beta + nsteps, slot(beta + nsteps));
}

template <int B>
int launch_band(float* e, long long ld, int nev, const float* v, const float* v2t, int k,
                int beta, int nact, int v0p, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(bt_apply_kernel<B>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (nev + kCols - 1) / kCols;
  bt_apply_kernel<B><<<grid, 2 * B, smem, stream>>>(e, ld, nev, v, v2t, k, beta, nact, v0p);
  return (int)cudaGetLastError();
}

int launch(float* e, long long ld, int nev, const float* v, const float* v2t, int b, int k,
           int beta, int nact, int v0p, cudaStream_t stream) {
  if (b < 32 || b % 32 || b > kMaxBand || k < 1 || nact < 0 || nact > k || nev < 0 ||
      beta < 0 || (nact > 0 && v0p < 1))
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(k, b);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  if (nact == 0 || nev == 0) return (int)cudaSuccess;   // no chase to run
  switch (b) {   // the band is a template parameter: every index folds
    case 32: return launch_band<32>(e, ld, nev, v, v2t, k, beta, nact, v0p, smem, stream);
    case 64: return launch_band<64>(e, ld, nev, v, v2t, k, beta, nact, v0p, smem, stream);
    case 96: return launch_band<96>(e, ld, nev, v, v2t, k, beta, nact, v0p, smem, stream);
    case 128: return launch_band<128>(e, ld, nev, v, v2t, k, beta, nact, v0p, smem, stream);
    case 160: return launch_band<160>(e, ld, nev, v, v2t, k, beta, nact, v0p, smem, stream);
    default: return launch_band<192>(e, ld, nev, v, v2t, k, beta, nact, v0p, smem, stream);
  }
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
