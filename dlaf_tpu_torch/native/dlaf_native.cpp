// Native host-side runtime components for dlaf_tpu_torch: a copy of
// dlaf_tpu/native/dlaf_native.cpp (the port does not read the JAX package's
// files), built with g++ at first use by dlaf_tpu_torch/native/__init__.py.
//
// Two pieces the reference also keeps native:
//  - block-cyclic pack/unpack between global row-major arrays and per-rank
//    ScaLAPACK-style local layouts (the analog of the reference's
//    LayoutInfo + matrix/copy.h host paths and src/c_api/utils.cpp pointer
//    wrapping) — memory-bandwidth bound, far too slow in Python loops;
//  - a CPU band->tridiagonal bulge-chasing kernel with Householder reflector
//    recording, mirroring the reference's deliberate choice to keep this
//    latency-bound stage on the CPU (eigensolver/band_to_tridiag/api.h:37-42,
//    Backend::MC only). Same (sweep, chase) reflector layout as the strip chase and
//    kernel K3 record, so the back-transformation consumes either.
//
// Exposed with C linkage for ctypes; f32 and f64 instantiations.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// pack/unpack: global (row-major, ld = n) <-> local (column-major, ScaLAPACK)

template <typename T>
void pack_local(const T* g, int64_t m, int64_t n, int64_t mb, int64_t nb,
                int64_t P, int64_t Q, int64_t p, int64_t q, int64_t isrc,
                int64_t jsrc, T* loc, int64_t lld) {
  const int64_t mt = ceil_div(m, mb);
  const int64_t nt = ceil_div(n, nb);
  for (int64_t gj = 0; gj < nt; ++gj) {
    if ((gj + jsrc) % Q != q) continue;
    const int64_t lj = gj / Q;
    const int64_t c0 = gj * nb;
    const int64_t cs = (c0 + nb <= n) ? nb : (n - c0);
    for (int64_t gi = 0; gi < mt; ++gi) {
      if ((gi + isrc) % P != p) continue;
      const int64_t li = gi / P;
      const int64_t r0 = gi * mb;
      const int64_t rs = (r0 + mb <= m) ? mb : (m - r0);
      for (int64_t c = 0; c < cs; ++c) {
        const T* src = g + r0 * n + (c0 + c);
        T* dst = loc + (lj * nb + c) * lld + li * mb;
        for (int64_t r = 0; r < rs; ++r) dst[r] = src[r * n];
      }
    }
  }
}

template <typename T>
void unpack_local(const T* loc, int64_t m, int64_t n, int64_t mb, int64_t nb,
                  int64_t P, int64_t Q, int64_t p, int64_t q, int64_t isrc,
                  int64_t jsrc, T* g, int64_t lld) {
  const int64_t mt = ceil_div(m, mb);
  const int64_t nt = ceil_div(n, nb);
  for (int64_t gj = 0; gj < nt; ++gj) {
    if ((gj + jsrc) % Q != q) continue;
    const int64_t lj = gj / Q;
    const int64_t c0 = gj * nb;
    const int64_t cs = (c0 + nb <= n) ? nb : (n - c0);
    for (int64_t gi = 0; gi < mt; ++gi) {
      if ((gi + isrc) % P != p) continue;
      const int64_t li = gi / P;
      const int64_t r0 = gi * mb;
      const int64_t rs = (r0 + mb <= m) ? mb : (m - r0);
      for (int64_t c = 0; c < cs; ++c) {
        const T* src = loc + (lj * nb + c) * lld + li * mb;
        T* dst = g + r0 * n + (c0 + c);
        for (int64_t r = 0; r < rs; ++r) dst[r * n] = src[r];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// band -> tridiagonal bulge chasing on a dense symmetric matrix (row-major,
// n x n, bandwidth b). Records reflector c of sweep s (acting on rows
// [s+1+c*b, s+1+(c+1)*b)) at vs[(s*ncmax + c)*b ..] / taus[s*ncmax + c].

template <typename T>
void householder(const T* x, int64_t len, T* v, T* tau, T* beta) {
  T normsq = 0;
  for (int64_t i = 0; i < len; ++i) normsq += x[i] * x[i];
  const T norm = std::sqrt(normsq);
  const T x0 = x[0];
  const T b = (x0 >= 0) ? -norm : norm;
  const T denom = x0 - b;
  if (std::abs(denom) == T(0)) {
    for (int64_t i = 0; i < len; ++i) v[i] = 0;
    v[0] = 1;
    *tau = 0;
    *beta = x0;
    return;
  }
  v[0] = 1;
  for (int64_t i = 1; i < len; ++i) v[i] = x[i] / denom;
  *tau = (b - x0) / b;
  *beta = b;
}

template <typename T>
void band_to_tridiag_dense(T* a, int64_t n, int64_t b, T* d, T* e, T* vs,
                           T* taus, int64_t ncmax) {
  if (n <= 0) return;
  std::vector<T> v(b), x(b), w;
  const int64_t nsweeps = (n > 2) ? n - 2 : 0;
  for (int64_t s = 0; s < nsweeps; ++s) {
    const int64_t nc = ceil_div(n - 1 - s, b);
    for (int64_t c = 0; c < nc; ++c) {
      const int64_t i0 = s + 1 + c * b;
      const int64_t j = (c == 0) ? s : s + 1 + (c - 1) * b;
      const int64_t len = (i0 + b <= n) ? b : (n - i0);
      if (len <= 0) continue;
      for (int64_t r = 0; r < len; ++r) x[r] = a[(i0 + r) * n + j];
      T tau, beta;
      householder(x.data(), len, v.data(), &tau, &beta);
      // eliminated column (and symmetric mirror)
      a[i0 * n + j] = beta;
      a[j * n + i0] = beta;
      for (int64_t r = 1; r < len; ++r) {
        a[(i0 + r) * n + j] = 0;
        a[j * n + (i0 + r)] = 0;
      }
      // two-sided windowed update on cols (j, j + 3b + 2)
      const int64_t w0 = j + 1;
      const int64_t w1 = std::min<int64_t>(n, j + 3 * b + 2);
      const int64_t wlen = w1 - w0;
      if ((int64_t)w.size() < wlen) w.resize(wlen);
      // left: rows [i0, i0+len) x cols [w0, w1):  A -= tau v (v^T A)
      for (int64_t cc = 0; cc < wlen; ++cc) {
        T acc = 0;
        for (int64_t r = 0; r < len; ++r) acc += v[r] * a[(i0 + r) * n + (w0 + cc)];
        w[cc] = acc;
      }
      for (int64_t r = 0; r < len; ++r) {
        const T tv = tau * v[r];
        T* row = a + (i0 + r) * n + w0;
        for (int64_t cc = 0; cc < wlen; ++cc) row[cc] -= tv * w[cc];
      }
      // right: rows [w0, w1) x cols [i0, i0+len): A -= tau (A v) v^T
      for (int64_t rr = 0; rr < wlen; ++rr) {
        T* row = a + (w0 + rr) * n + i0;
        T acc = 0;
        for (int64_t r = 0; r < len; ++r) acc += row[r] * v[r];
        acc *= tau;
        for (int64_t r = 0; r < len; ++r) row[r] -= acc * v[r];
      }
      // record
      T* vrec = vs + (s * ncmax + c) * b;
      for (int64_t r = 0; r < len; ++r) vrec[r] = v[r];
      for (int64_t r = len; r < b; ++r) vrec[r] = 0;
      taus[s * ncmax + c] = tau;
    }
  }
  for (int64_t i = 0; i < n; ++i) d[i] = a[i * n + i];
  for (int64_t i = 0; i + 1 < n; ++i) e[i] = a[(i + 1) * n + i];
}

}  // namespace

extern "C" {

#define DEFINE_PACK(suffix, T)                                              \
  void pack_local_##suffix(const T* g, int64_t m, int64_t n, int64_t mb,    \
                           int64_t nb, int64_t P, int64_t Q, int64_t p,     \
                           int64_t q, int64_t isrc, int64_t jsrc, T* loc,   \
                           int64_t lld) {                                   \
    pack_local<T>(g, m, n, mb, nb, P, Q, p, q, isrc, jsrc, loc, lld);       \
  }                                                                         \
  void unpack_local_##suffix(const T* loc, int64_t m, int64_t n,            \
                             int64_t mb, int64_t nb, int64_t P, int64_t Q,  \
                             int64_t p, int64_t q, int64_t isrc,            \
                             int64_t jsrc, T* g, int64_t lld) {             \
    unpack_local<T>(loc, m, n, mb, nb, P, Q, p, q, isrc, jsrc, g, lld);     \
  }

DEFINE_PACK(f32, float)
DEFINE_PACK(f64, double)

void band_to_tridiag_f32(float* a, int64_t n, int64_t b, float* d, float* e,
                         float* vs, float* taus, int64_t ncmax) {
  band_to_tridiag_dense<float>(a, n, b, d, e, vs, taus, ncmax);
}
void band_to_tridiag_f64(double* a, int64_t n, int64_t b, double* d,
                         double* e, double* vs, double* taus, int64_t ncmax) {
  band_to_tridiag_dense<double>(a, n, b, d, e, vs, taus, ncmax);
}

}  // extern "C"
