/* A plain C caller of the port's C API (dlaf_tpu_c.h) at full size:
 *
 *   dlaf_card_driver [n_potrf [n_syevd [nb]]]      (default 32768 8192 512)
 *
 * Makes a diagonally dominant symmetric f32 matrix of order n_potrf in
 * O(n^2) (off-diagonal entries a hash of (min(i, j), max(i, j)) in
 * [-0.5, 0.5), diagonal n), factors it with dlaf_pspotrf ('L', 1x1 grid,
 * blocks nb) and checks |L L^T - A| on 4096 sampled entries (64 rows by
 * 64 rows) in double; then the same generator at n_syevd through
 * dlaf_pssyevd, with the residual |A z - w z| of 8 eigenpairs, their
 * mutual orthogonality and the ascending order of w checked in double. The
 * entries of A are recomputed from the hash, so no copy of A is kept. An
 * order of 0 leaves that call out, so that the two calls can run in two
 * processes at once.
 *
 * Prints one JSON line with the times (wall seconds around each call) and
 * the readings: res_potrf in units of eps32 max|A|, res_syevd in units of
 * n eps32 max|A|, orth_syevd in units of n eps32. Exits 0 when the
 * readings are within RES_POTRF_BOUND, RES_SYEVD_BOUND and ORTH_BOUND and
 * every call returned 0; the device is DLAF_TPU_TORCH_DEVICE (default
 * cuda). Built and run by chip_smoke.py (and, small, by the tests).
 */
#include "dlaf_tpu_c.h"

#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <time.h>

#define EPS32 1.1920928955078125e-07
#define RES_POTRF_BOUND 16.0
#define RES_SYEVD_BOUND 1.0
#define ORTH_BOUND 1.0
#define ROWS 64 /* ROWS x ROWS = 4096 sampled entries of L L^T */
#define PAIRS 8

static double now(void) {
  struct timespec t;
  clock_gettime(CLOCK_MONOTONIC, &t);
  return (double)t.tv_sec + 1e-9 * (double)t.tv_nsec;
}

/* the (i, j) entry of the test matrix of order n */
static float entry(int64_t i, int64_t j, int64_t n) {
  if (i == j) return (float)n;
  uint64_t lo = (uint64_t)(i < j ? i : j), hi = (uint64_t)(i < j ? j : i);
  uint64_t h = (lo * 0x9E3779B97F4A7C15ull) ^ (hi + 0x632BE59BD9B4E019ull);
  h ^= h >> 31;
  h *= 0xBF58476D1CE4E5B9ull;
  h ^= h >> 29;
  return (float)(h >> 40) * (1.0f / 16777216.0f) - 0.5f;   /* exact: 24 bits */
}

static float* make(int64_t n) {
  float* a = (float*)malloc((size_t)(n * n) * sizeof(float));
  if (!a) return NULL;
  for (int64_t j = 0; j < n; ++j)
    for (int64_t i = 0; i < n; ++i) a[j * n + i] = entry(i, j, n);
  return a;
}

static uint64_t lcg(uint64_t* s) {
  *s = *s * 6364136223846793005ull + 1442695040888963407ull;
  return *s >> 33;
}

/* dlaf_pspotrf on the order-n matrix; its seconds and |L L^T - A| on 64 x 64
 * sampled entries (rows i of one sample, rows j of another, each row of L
 * gathered once: column-major, a row is strided) in units of eps32 max|A|.
 * Returns the call's info, or -1 where memory runs out. */
static int run_potrf(int64_t n, int nb, int ctx, double* seconds, double* reading) {
  float* a = make(n);
  double* lr = (double*)malloc((size_t)(2 * ROWS * n) * sizeof(double));
  if (!a || !lr) return -1;
  int desc[9] = {1, ctx, (int)n, (int)n, nb, nb, 0, 0, (int)n};
  double t0 = now();
  int info = dlaf_pspotrf('L', (int)n, a, 1, 1, desc, ctx);
  *seconds = now() - t0;
  if (info != 0) return info;
  double res = 0.0;
  uint64_t seed = 7;
  int64_t rows[2][ROWS];
  for (int s = 0; s < 2; ++s)
    for (int r = 0; r < ROWS; ++r) {
      rows[s][r] = (int64_t)(lcg(&seed) % (uint64_t)n);
      double* dst = lr + (size_t)(s * ROWS + r) * (size_t)n;
      for (int64_t k = 0; k < n; ++k)
        dst[k] = k <= rows[s][r] ? (double)a[k * n + rows[s][r]] : 0.0;
    }
  for (int r = 0; r < ROWS; ++r)
    for (int c = 0; c < ROWS; ++c) {
      const double* li = lr + (size_t)r * (size_t)n;
      const double* lj = lr + (size_t)(ROWS + c) * (size_t)n;
      double acc = 0.0;
      for (int64_t k = 0; k < n; ++k) acc += li[k] * lj[k];
      double d = fabs(acc - (double)entry(rows[0][r], rows[1][c], n));
      if (d > res) res = d;
    }
  *reading = res / (EPS32 * (double)n); /* max|A| = n, the diagonal */
  free(lr);
  free(a);
  return 0;
}

/* dlaf_pssyevd on the order-n matrix; its seconds, the residual of PAIRS
 * eigenpairs in units of n eps32 max|A|, their orthogonality in units of
 * n eps32, and whether w ascends. Returns the call's code, or -1. */
static int run_syevd(int64_t n, int nb, int ctx, double* seconds, double* res_reading,
                     double* orth_reading, int* ascending) {
  float* b = make(n);
  float* w = (float*)malloc((size_t)n * sizeof(float));
  float* z = (float*)malloc((size_t)(n * n) * sizeof(float));
  if (!b || !w || !z) return -1;
  int desc[9] = {1, ctx, (int)n, (int)n, nb, nb, 0, 0, (int)n};
  double t0 = now();
  int rc = dlaf_pssyevd('L', (int)n, b, desc, w, z, ctx);
  *seconds = now() - t0;
  free(b);
  if (rc != 0) return rc;
  *ascending = 1;
  for (int64_t i = 1; i < n; ++i)
    if (w[i] < w[i - 1]) *ascending = 0;
  double res = 0.0, orth = 0.0;
  int64_t cols[PAIRS];
  for (int c = 0; c < PAIRS; ++c) cols[c] = c * (n - 1) / (PAIRS - 1);
  for (int c = 0; c < PAIRS; ++c) {
    const float* zc = z + cols[c] * n;
    for (int64_t i = 0; i < n; ++i) {
      double acc = 0.0;
      for (int64_t k = 0; k < n; ++k) acc += (double)entry(i, k, n) * (double)zc[k];
      double d = fabs(acc - (double)w[cols[c]] * (double)zc[i]);
      if (d > res) res = d;
    }
    for (int c2 = 0; c2 <= c; ++c2) {
      const float* zd = z + cols[c2] * n;
      double acc = 0.0;
      for (int64_t k = 0; k < n; ++k) acc += (double)zc[k] * (double)zd[k];
      double d = fabs(acc - (c2 == c ? 1.0 : 0.0));
      if (d > orth) orth = d;
    }
  }
  double unit = (double)n * EPS32;
  *res_reading = res / (unit * (double)n); /* max|A| = n */
  *orth_reading = orth / unit;
  free(w);
  free(z);
  return 0;
}

int main(int argc, char** argv) {
  int64_t n = argc > 1 ? atoll(argv[1]) : 32768;
  int64_t n2 = argc > 2 ? atoll(argv[2]) : 8192;
  int nb = argc > 3 ? atoi(argv[3]) : 512;
  double t0 = now();
  if (dlaf_initialize() != 0) return 1;
  double t_init = now() - t0;
  int ctx = dlaf_create_grid(1, 1);
  if (ctx < 0) return 2;
  double t_potrf = 0.0, res_potrf = 0.0, t_syevd = 0.0, res_syevd = 0.0, orth_syevd = 0.0;
  int ascending = 1;
  int rc = n > 0 ? run_potrf(n, nb, ctx, &t_potrf, &res_potrf) : 0;
  if (rc != 0) {
    fprintf(stderr, "dlaf_pspotrf: %d\n", rc);
    return 4;
  }
  rc = n2 > 0 ? run_syevd(n2, nb, ctx, &t_syevd, &res_syevd, &orth_syevd, &ascending) : 0;
  if (rc != 0) {
    fprintf(stderr, "dlaf_pssyevd: %d\n", rc);
    return 6;
  }
  dlaf_free_grid(ctx);
  t0 = now();
  if (dlaf_finalize() != 0) return 7;
  double t_finalize = now() - t0;
  printf("{\"card_driver\": {\"potrf_n\": %lld, \"syevd_n\": %lld, \"nb\": %d, "
         "\"initialize_s\": %.6f, \"potrf_s\": %.6f, \"syevd_s\": %.6f, \"finalize_s\": %.6f, "
         "\"res_potrf\": %.6g, \"res_syevd\": %.6g, \"orth_syevd\": %.6g, \"ascending\": %d, "
         "\"bounds\": {\"res_potrf\": %g, \"res_syevd\": %g, \"orth_syevd\": %g}}}\n",
         (long long)n, (long long)n2, nb, t_init, t_potrf, t_syevd, t_finalize, res_potrf,
         res_syevd, orth_syevd, ascending, RES_POTRF_BOUND, RES_SYEVD_BOUND, ORTH_BOUND);
  fflush(stdout);
  if (!ascending || res_potrf > RES_POTRF_BOUND || res_syevd > RES_SYEVD_BOUND ||
      orth_syevd > ORTH_BOUND)
    return 8;
  return 0;
}
