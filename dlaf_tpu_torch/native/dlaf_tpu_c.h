/* C API for dlaf_tpu_torch — the port's copy of dlaf_tpu/native/dlaf_tpu_c.h,
 * with the same functions: the analog of the reference's include/dlaf_c/
 * (init.h, grid.h, desc.h, factorization/cholesky.h:74-86,
 * eigensolver/eigensolver.h:36-55), a C/Fortran-callable surface over the
 * PyTorch/CUDA library, reached through an embedded interpreter.
 *
 * Execution model: the reference's MPI model, one process per rank,
 * started as many times as the grid has ranks. dlaf_initialize joins the
 * torch.distributed process group that the environment describes when
 * WORLD_SIZE > 1 (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, as torchrun
 * sets them). Every rank passes the GLOBAL column-major matrix and gets
 * the whole result back; the library scatters it onto the grid. The
 * ScaLAPACK descriptor keeps its standard 9-integer layout (dtype, ctxt,
 * m, n, mb, nb, rsrc, csrc, lld).
 *
 * Device: DLAF_TPU_TORCH_DEVICE=cuda (the default; rank r runs on
 * cuda:r % device_count, and the call fails where there is no CUDA
 * device) or cpu.
 *
 * All functions return 0 on success, <0 on error (-1 interpreter/library
 * failure, a grid whose size is not the number of ranks included; potrf
 * returns the LAPACK-style info > 0 for a non-SPD leading minor).
 */
#ifndef DLAF_TPU_C_H
#define DLAF_TPU_C_H

#ifdef __cplusplus
extern "C" {
#endif

/* Start the embedded runtime (idempotent) and, when WORLD_SIZE > 1, join
 * the process group. */
int dlaf_initialize(void);
/* Leave the process group it joined and shut the runtime down. */
int dlaf_finalize(void);

/* Register a (nprow, npcol) process grid over the ranks (nprow * npcol
 * must be the number of ranks); returns a context handle >= 0
 * (reference dlaf_create_grid, include/dlaf_c/grid.h:31-71). The ordered
 * variant picks the rank->(p, q) assignment: 'R'ow- or
 * 'C'olumn-major (the reference's order argument). dlaf_create_grid is
 * row-major. */
int dlaf_create_grid(int nprow, int npcol);
int dlaf_create_grid_ordered(int nprow, int npcol, char order);
int dlaf_free_grid(int ctx);

/* Cholesky factorization, global column-major a (n x n, lld >= n).
 * (reference dlaf_pspotrf/pdpotrf, include/dlaf_c/factorization/cholesky.h) */
int dlaf_pspotrf(char uplo, int n, float* a, int ia, int ja,
                 const int* desca, int ctx);
int dlaf_pdpotrf(char uplo, int n, double* a, int ia, int ja,
                 const int* desca, int ctx);
/* complex variants: a points to interleaved (re, im) pairs
 * (C99 float/double _Complex or Fortran COMPLEX layout) */
int dlaf_pcpotrf(char uplo, int n, void* a, int ia, int ja,
                 const int* desca, int ctx);
int dlaf_pzpotrf(char uplo, int n, void* a, int ia, int ja,
                 const int* desca, int ctx);

/* Symmetric eigensolver: eigenvalues into w (n), eigenvectors into z
 * (n x n column-major). (reference dlaf_pssyevd/pdsyevd) */
int dlaf_pssyevd(char uplo, int n, float* a, const int* desca,
                 float* w, float* z, int ctx);
int dlaf_pdsyevd(char uplo, int n, double* a, const int* desca,
                 double* w, double* z, int ctx);
/* hermitian: complex a/z, REAL eigenvalues w (float/double) */
int dlaf_pcheevd(char uplo, int n, void* a, const int* desca,
                 float* w, void* z, int ctx);
int dlaf_pzheevd(char uplo, int n, void* a, const int* desca,
                 double* w, void* z, int ctx);

/* Generalized eigensolver A x = lambda B x (B SPD/HPD): eigenvalues into
 * w (n), eigenvectors into z (n x n column-major, compact). The
 * "_factorized" variants take b already Cholesky-factored (the output of
 * dlaf_p?potrf with the same uplo). (reference dlaf_pssygvd/pdsygvd/
 * pchegvd/pzhegvd [+_factorized], include/dlaf_c/eigensolver/
 * gen_eigensolver.h:147-266) */
int dlaf_pssygvd(char uplo, int n, float* a, int ia, int ja,
                 const int* desca, float* b, int ib, int jb,
                 const int* descb, float* w, float* z, int ctx);
int dlaf_pdsygvd(char uplo, int n, double* a, int ia, int ja,
                 const int* desca, double* b, int ib, int jb,
                 const int* descb, double* w, double* z, int ctx);
int dlaf_pchegvd(char uplo, int n, void* a, int ia, int ja,
                 const int* desca, void* b, int ib, int jb,
                 const int* descb, float* w, void* z, int ctx);
int dlaf_pzhegvd(char uplo, int n, void* a, int ia, int ja,
                 const int* desca, void* b, int ib, int jb,
                 const int* descb, double* w, void* z, int ctx);
int dlaf_pssygvd_factorized(char uplo, int n, float* a, int ia, int ja,
                            const int* desca, float* b, int ib, int jb,
                            const int* descb, float* w, float* z, int ctx);
int dlaf_pdsygvd_factorized(char uplo, int n, double* a, int ia, int ja,
                            const int* desca, double* b, int ib, int jb,
                            const int* descb, double* w, double* z, int ctx);
int dlaf_pchegvd_factorized(char uplo, int n, void* a, int ia, int ja,
                            const int* desca, void* b, int ib, int jb,
                            const int* descb, float* w, void* z, int ctx);
int dlaf_pzhegvd_factorized(char uplo, int n, void* a, int ia, int ja,
                            const int* desca, void* b, int ib, int jb,
                            const int* descb, double* w, void* z, int ctx);

/* ------------------------------------------------------------------------
 * Descriptor-based entries (reference include/dlaf_c/desc.h:16 and the
 * typed non-ScaLAPACK surface: factorization/cholesky.h:32-45,
 * eigensolver/eigensolver.h:36-55, eigensolver/gen_eigensolver.h).
 * `ld` is the leading dimension of the GLOBAL column-major buffer that
 * every rank passes (ld >= m; 0 means m); the
 * submatrix offsets i/j must be 0, like the reference requires. */
struct DLAF_descriptor {
  int m;     /* rows of the global matrix */
  int n;     /* cols of the global matrix */
  int mb;    /* row blocking factor */
  int nb;    /* col blocking factor */
  int isrc;  /* process row of the first row */
  int jsrc;  /* process col of the first col */
  int i;     /* first row of the submatrix (must be 0) */
  int j;     /* first col of the submatrix (must be 0) */
  int ld;    /* leading dimension of the buffer */
};

/* Build a DLAF_descriptor from a ScaLAPACK desc[9]
 * (reference include/dlaf_c/utils.h:43). */
struct DLAF_descriptor make_dlaf_descriptor(int m, int n, int i, int j,
                                            const int desc[9]);

/* Cholesky factorization on the stored-uplo triangle of a
 * (reference dlaf_cholesky_factorization_{s,d,c,z}). */
int dlaf_cholesky_factorization_s(int ctx, char uplo, float* a,
                                  struct DLAF_descriptor desca);
int dlaf_cholesky_factorization_d(int ctx, char uplo, double* a,
                                  struct DLAF_descriptor desca);
int dlaf_cholesky_factorization_c(int ctx, char uplo, void* a,
                                  struct DLAF_descriptor desca);
int dlaf_cholesky_factorization_z(int ctx, char uplo, void* a,
                                  struct DLAF_descriptor desca);

/* Standard eigensolver: w gets desca.m eigenvalues; z is written with
 * descz's ld stride (reference dlaf_symmetric_eigensolver_{s,d} /
 * dlaf_hermitian_eigensolver_{c,z}). */
int dlaf_symmetric_eigensolver_s(int ctx, char uplo, float* a,
                                 struct DLAF_descriptor desca, float* w,
                                 float* z, struct DLAF_descriptor descz);
int dlaf_symmetric_eigensolver_d(int ctx, char uplo, double* a,
                                 struct DLAF_descriptor desca, double* w,
                                 double* z, struct DLAF_descriptor descz);
int dlaf_hermitian_eigensolver_c(int ctx, char uplo, void* a,
                                 struct DLAF_descriptor desca, float* w,
                                 void* z, struct DLAF_descriptor descz);
int dlaf_hermitian_eigensolver_z(int ctx, char uplo, void* a,
                                 struct DLAF_descriptor desca, double* w,
                                 void* z, struct DLAF_descriptor descz);

/* Generalized eigensolver (reference
 * dlaf_{symmetric,hermitian}_generalized_eigensolver[_factorized]_*). */
int dlaf_symmetric_generalized_eigensolver_s(
    int ctx, char uplo, float* a, struct DLAF_descriptor desca, float* b,
    struct DLAF_descriptor descb, float* w, float* z,
    struct DLAF_descriptor descz);
int dlaf_symmetric_generalized_eigensolver_d(
    int ctx, char uplo, double* a, struct DLAF_descriptor desca, double* b,
    struct DLAF_descriptor descb, double* w, double* z,
    struct DLAF_descriptor descz);
int dlaf_hermitian_generalized_eigensolver_c(
    int ctx, char uplo, void* a, struct DLAF_descriptor desca, void* b,
    struct DLAF_descriptor descb, float* w, void* z,
    struct DLAF_descriptor descz);
int dlaf_hermitian_generalized_eigensolver_z(
    int ctx, char uplo, void* a, struct DLAF_descriptor desca, void* b,
    struct DLAF_descriptor descb, double* w, void* z,
    struct DLAF_descriptor descz);
int dlaf_symmetric_generalized_eigensolver_factorized_s(
    int ctx, char uplo, float* a, struct DLAF_descriptor desca, float* b,
    struct DLAF_descriptor descb, float* w, float* z,
    struct DLAF_descriptor descz);
int dlaf_symmetric_generalized_eigensolver_factorized_d(
    int ctx, char uplo, double* a, struct DLAF_descriptor desca, double* b,
    struct DLAF_descriptor descb, double* w, double* z,
    struct DLAF_descriptor descz);
int dlaf_hermitian_generalized_eigensolver_factorized_c(
    int ctx, char uplo, void* a, struct DLAF_descriptor desca, void* b,
    struct DLAF_descriptor descb, float* w, void* z,
    struct DLAF_descriptor descz);
int dlaf_hermitian_generalized_eigensolver_factorized_z(
    int ctx, char uplo, void* a, struct DLAF_descriptor desca, void* b,
    struct DLAF_descriptor descb, double* w, void* z,
    struct DLAF_descriptor descz);

#ifdef __cplusplus
}
#endif

#endif /* DLAF_TPU_C_H */
