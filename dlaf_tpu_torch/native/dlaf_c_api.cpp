// C API shim for dlaf_tpu_torch (see dlaf_tpu_c.h): embeds a CPython
// interpreter and dispatches into dlaf_tpu_torch.native.c_entry, which does
// all the numpy buffer wrapping. The port's counterpart of
// dlaf_tpu/native/dlaf_c_api.cpp (the reference's src/c_api/*.cpp layer:
// grid registry src/c_api/grid.cpp:1-93, typed wrappers
// src/c_api/factorization/cholesky.cpp).
//
// Built by dlaf_tpu_torch.native.build_c_api(), which generates
// dlaf_c_api_config.h: DLAF_PACKAGE_ROOT, the directory that holds the
// package, and DLAF_SYS_PATH, the building interpreter's sys.path as a JSON
// list (an embedded interpreter takes its path from libpython's prefix
// alone, which misses a virtual environment's site-packages).
#include "dlaf_tpu_c.h"
#include "dlaf_c_api_config.h"

#include <Python.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

namespace {

PyThreadState* g_main_tstate = nullptr;
bool g_we_initialized = false;

// Put the package root and the building interpreter's sys.path on this
// interpreter's path (site directories through site.addsitedir, which also
// reads their .pth files). Returns PyRun_SimpleString's code.
int setup_path() {
  PyObject* main = PyImport_AddModule("__main__");
  if (!main) return -1;
  PyObject* d = PyModule_GetDict(main);
  PyObject* root = PyUnicode_FromString(DLAF_PACKAGE_ROOT);
  PyObject* path = PyUnicode_FromString(DLAF_SYS_PATH);
  if (!root || !path) {
    Py_XDECREF(root);
    Py_XDECREF(path);
    return -1;
  }
  PyDict_SetItemString(d, "_dlaf_root", root);
  PyDict_SetItemString(d, "_dlaf_path", path);
  Py_DECREF(root);
  Py_DECREF(path);
  return PyRun_SimpleString(
      "import json, site, sys\n"
      "for _p in [_dlaf_root] + json.loads(_dlaf_path):\n"
      "    if _p not in sys.path:\n"
      "        (site.addsitedir(_p) if _p.endswith(('site-packages', 'dist-packages'))\n"
      "         else sys.path.append(_p))\n"
      "if sys.path[0] != _dlaf_root:\n"
      "    sys.path.insert(0, _dlaf_root)\n"
      "del _dlaf_root, _dlaf_path\n");
}

PyObject* entry_module() {
  PyObject* mod = PyImport_ImportModule("dlaf_tpu_torch.native.c_entry");
  if (!mod) PyErr_Print();
  return mod;
}

// Build a Python tuple of 9 ints from a ScaLAPACK descriptor.
PyObject* desc_tuple(const int* desca) {
  PyObject* t = PyTuple_New(9);
  for (int i = 0; i < 9; ++i)
    PyTuple_SET_ITEM(t, i, PyLong_FromLong(desca[i]));
  return t;
}

int call_int(const char* fn, PyObject* args) {
  // takes ownership of args; returns the int result or -1
  int rc = -1;
  PyObject* mod = entry_module();
  if (mod) {
    PyObject* f = PyObject_GetAttrString(mod, fn);
    if (f) {
      PyObject* r = PyObject_CallObject(f, args);
      if (r) {
        rc = static_cast<int>(PyLong_AsLong(r));
        Py_DECREF(r);
      }
      else {
        PyErr_Print();
      }
      Py_DECREF(f);
    }
    Py_DECREF(mod);
  }
  Py_XDECREF(args);
  return rc;
}

}  // namespace

extern "C" {

int dlaf_initialize(void) {
  if (Py_IsInitialized()) {
    // the embedding host already runs Python (or this library was loaded
    // from a Python process): make the package importable and initialize
    PyGILState_STATE g = PyGILState_Ensure();
    int rc = setup_path() == 0 ? call_int("c_initialize", PyTuple_New(0)) : -1;
    PyGILState_Release(g);
    return rc;
  }
  Py_InitializeEx(0);
  if (!Py_IsInitialized()) return -1;
  g_we_initialized = true;
  // import eagerly (and join the process group of a run of several ranks)
  // so that the first compute call pays no start-up
  int rc = setup_path() == 0 ? call_int("c_initialize", PyTuple_New(0)) : -1;
  g_main_tstate = PyEval_SaveThread();
  return rc;
}

int dlaf_finalize(void) {
  if (!Py_IsInitialized()) return 0;
  if (!g_we_initialized) {
    PyGILState_STATE g = PyGILState_Ensure();
    int rc = call_int("c_finalize", PyTuple_New(0));
    PyGILState_Release(g);
    return rc;
  }
  if (g_main_tstate) PyEval_RestoreThread(g_main_tstate);
  int rc = call_int("c_finalize", PyTuple_New(0));
  Py_Finalize();
  g_main_tstate = nullptr;
  g_we_initialized = false;
  return rc;
}

int dlaf_create_grid(int nprow, int npcol) {
  return dlaf_create_grid_ordered(nprow, npcol, 'R');
}

int dlaf_create_grid_ordered(int nprow, int npcol, char order) {
  PyGILState_STATE g = PyGILState_Ensure();
  char o[2] = {order, 0};
  int rc =
      call_int("c_create_grid", Py_BuildValue("(iis)", nprow, npcol, o));
  PyGILState_Release(g);
  return rc;
}

int dlaf_free_grid(int ctx) {
  PyGILState_STATE g = PyGILState_Ensure();
  int rc = call_int("c_free_grid", Py_BuildValue("(i)", ctx));
  PyGILState_Release(g);
  return rc;
}

static int ppotrf(char uplo, int n, void* a, int ia, int ja, const int* desca,
                  int ctx, const char* dt) {
  PyGILState_STATE g = PyGILState_Ensure();
  char u[2] = {uplo, 0};
  PyObject* args =
      Py_BuildValue("(siKiiNis)", u, n, (unsigned long long)(uintptr_t)a, ia,
                    ja, desc_tuple(desca), ctx, dt);
  int rc = call_int("c_ppotrf", args);
  PyGILState_Release(g);
  return rc;
}

int dlaf_pspotrf(char uplo, int n, float* a, int ia, int ja, const int* desca,
                 int ctx) {
  return ppotrf(uplo, n, a, ia, ja, desca, ctx, "float32");
}

int dlaf_pdpotrf(char uplo, int n, double* a, int ia, int ja,
                 const int* desca, int ctx) {
  return ppotrf(uplo, n, a, ia, ja, desca, ctx, "float64");
}

int dlaf_pcpotrf(char uplo, int n, void* a, int ia, int ja, const int* desca,
                 int ctx) {
  return ppotrf(uplo, n, a, ia, ja, desca, ctx, "complex64");
}

int dlaf_pzpotrf(char uplo, int n, void* a, int ia, int ja, const int* desca,
                 int ctx) {
  return ppotrf(uplo, n, a, ia, ja, desca, ctx, "complex128");
}

static int psyevd(char uplo, int n, void* a, const int* desca, void* w,
                  void* z, int ctx, const char* dt) {
  PyGILState_STATE g = PyGILState_Ensure();
  char u[2] = {uplo, 0};
  PyObject* args = Py_BuildValue(
      "(siKNKKis)", u, n, (unsigned long long)(uintptr_t)a, desc_tuple(desca),
      (unsigned long long)(uintptr_t)w, (unsigned long long)(uintptr_t)z, ctx,
      dt);
  int rc = call_int("c_psyevd", args);
  PyGILState_Release(g);
  return rc;
}

int dlaf_pssyevd(char uplo, int n, float* a, const int* desca, float* w,
                 float* z, int ctx) {
  return psyevd(uplo, n, a, desca, w, z, ctx, "float32");
}

int dlaf_pdsyevd(char uplo, int n, double* a, const int* desca, double* w,
                 double* z, int ctx) {
  return psyevd(uplo, n, a, desca, w, z, ctx, "float64");
}

int dlaf_pcheevd(char uplo, int n, void* a, const int* desca, float* w,
                 void* z, int ctx) {
  return psyevd(uplo, n, a, desca, w, z, ctx, "complex64");
}

int dlaf_pzheevd(char uplo, int n, void* a, const int* desca, double* w,
                 void* z, int ctx) {
  return psyevd(uplo, n, a, desca, w, z, ctx, "complex128");
}

static int psygvd(char uplo, int n, void* a, int ia, int ja,
                  const int* desca, void* b, int ib, int jb,
                  const int* descb, void* w, void* z, int ctx,
                  const char* dt, int factorized) {
  PyGILState_STATE g = PyGILState_Ensure();
  char u[2] = {uplo, 0};
  PyObject* args = Py_BuildValue(
      "(siKiiNKiiNKKisi)", u, n, (unsigned long long)(uintptr_t)a, ia, ja,
      desc_tuple(desca), (unsigned long long)(uintptr_t)b, ib, jb,
      desc_tuple(descb), (unsigned long long)(uintptr_t)w,
      (unsigned long long)(uintptr_t)z, ctx, dt, factorized);
  int rc = call_int("c_psygvd", args);
  PyGILState_Release(g);
  return rc;
}

int dlaf_pssygvd(char uplo, int n, float* a, int ia, int ja,
                 const int* desca, float* b, int ib, int jb,
                 const int* descb, float* w, float* z, int ctx) {
  return psygvd(uplo, n, a, ia, ja, desca, b, ib, jb, descb, w, z, ctx,
                "float32", 0);
}

int dlaf_pdsygvd(char uplo, int n, double* a, int ia, int ja,
                 const int* desca, double* b, int ib, int jb,
                 const int* descb, double* w, double* z, int ctx) {
  return psygvd(uplo, n, a, ia, ja, desca, b, ib, jb, descb, w, z, ctx,
                "float64", 0);
}

int dlaf_pchegvd(char uplo, int n, void* a, int ia, int ja, const int* desca,
                 void* b, int ib, int jb, const int* descb, float* w, void* z,
                 int ctx) {
  return psygvd(uplo, n, a, ia, ja, desca, b, ib, jb, descb, w, z, ctx,
                "complex64", 0);
}

int dlaf_pzhegvd(char uplo, int n, void* a, int ia, int ja, const int* desca,
                 void* b, int ib, int jb, const int* descb, double* w,
                 void* z, int ctx) {
  return psygvd(uplo, n, a, ia, ja, desca, b, ib, jb, descb, w, z, ctx,
                "complex128", 0);
}

int dlaf_pssygvd_factorized(char uplo, int n, float* a, int ia, int ja,
                            const int* desca, float* b, int ib, int jb,
                            const int* descb, float* w, float* z, int ctx) {
  return psygvd(uplo, n, a, ia, ja, desca, b, ib, jb, descb, w, z, ctx,
                "float32", 1);
}

int dlaf_pdsygvd_factorized(char uplo, int n, double* a, int ia, int ja,
                            const int* desca, double* b, int ib, int jb,
                            const int* descb, double* w, double* z, int ctx) {
  return psygvd(uplo, n, a, ia, ja, desca, b, ib, jb, descb, w, z, ctx,
                "float64", 1);
}

int dlaf_pchegvd_factorized(char uplo, int n, void* a, int ia, int ja,
                            const int* desca, void* b, int ib, int jb,
                            const int* descb, float* w, void* z, int ctx) {
  return psygvd(uplo, n, a, ia, ja, desca, b, ib, jb, descb, w, z, ctx,
                "complex64", 1);
}

int dlaf_pzhegvd_factorized(char uplo, int n, void* a, int ia, int ja,
                            const int* desca, void* b, int ib, int jb,
                            const int* descb, double* w, void* z, int ctx) {
  return psygvd(uplo, n, a, ia, ja, desca, b, ib, jb, descb, w, z, ctx,
                "complex128", 1);
}

// ---------------------------------------------------------------------------
// descriptor-based entries (reference include/dlaf_c/desc.h, the typed
// non-ScaLAPACK surface)

struct DLAF_descriptor make_dlaf_descriptor(int m, int n, int i, int j,
                                            const int desc[9]) {
  struct DLAF_descriptor d = {m,       n,       desc[4], desc[5], desc[6],
                              desc[7], i,       j,       desc[8]};
  return d;
}

namespace {

PyObject* dlaf_desc_tuple(const struct DLAF_descriptor& d) {
  return Py_BuildValue("(iiiiiiiii)", d.m, d.n, d.mb, d.nb, d.isrc, d.jsrc,
                       d.i, d.j, d.ld);
}

int chol_desc(int ctx, char uplo, void* a, struct DLAF_descriptor da,
              const char* dt) {
  PyGILState_STATE g = PyGILState_Ensure();
  char u[2] = {uplo, 0};
  PyObject* args =
      Py_BuildValue("(isKNs)", ctx, u, (unsigned long long)(uintptr_t)a,
                    dlaf_desc_tuple(da), dt);
  int rc = call_int("c_chol_desc", args);
  PyGILState_Release(g);
  return rc;
}

int syevd_desc(int ctx, char uplo, void* a, struct DLAF_descriptor da,
               void* w, void* z, struct DLAF_descriptor dz, const char* dt) {
  PyGILState_STATE g = PyGILState_Ensure();
  char u[2] = {uplo, 0};
  PyObject* args = Py_BuildValue(
      "(isKNKKNs)", ctx, u, (unsigned long long)(uintptr_t)a,
      dlaf_desc_tuple(da), (unsigned long long)(uintptr_t)w,
      (unsigned long long)(uintptr_t)z, dlaf_desc_tuple(dz), dt);
  int rc = call_int("c_syevd_desc", args);
  PyGILState_Release(g);
  return rc;
}

int sygvd_desc(int ctx, char uplo, void* a, struct DLAF_descriptor da,
               void* b, struct DLAF_descriptor db, void* w, void* z,
               struct DLAF_descriptor dz, const char* dt, int factorized) {
  PyGILState_STATE g = PyGILState_Ensure();
  char u[2] = {uplo, 0};
  PyObject* args = Py_BuildValue(
      "(isKNKNKKNsi)", ctx, u, (unsigned long long)(uintptr_t)a,
      dlaf_desc_tuple(da), (unsigned long long)(uintptr_t)b,
      dlaf_desc_tuple(db), (unsigned long long)(uintptr_t)w,
      (unsigned long long)(uintptr_t)z, dlaf_desc_tuple(dz), dt, factorized);
  int rc = call_int("c_sygvd_desc", args);
  PyGILState_Release(g);
  return rc;
}

}  // namespace

int dlaf_cholesky_factorization_s(int ctx, char uplo, float* a,
                                  struct DLAF_descriptor desca) {
  return chol_desc(ctx, uplo, a, desca, "float32");
}
int dlaf_cholesky_factorization_d(int ctx, char uplo, double* a,
                                  struct DLAF_descriptor desca) {
  return chol_desc(ctx, uplo, a, desca, "float64");
}
int dlaf_cholesky_factorization_c(int ctx, char uplo, void* a,
                                  struct DLAF_descriptor desca) {
  return chol_desc(ctx, uplo, a, desca, "complex64");
}
int dlaf_cholesky_factorization_z(int ctx, char uplo, void* a,
                                  struct DLAF_descriptor desca) {
  return chol_desc(ctx, uplo, a, desca, "complex128");
}

int dlaf_symmetric_eigensolver_s(int ctx, char uplo, float* a,
                                 struct DLAF_descriptor desca, float* w,
                                 float* z, struct DLAF_descriptor descz) {
  return syevd_desc(ctx, uplo, a, desca, w, z, descz, "float32");
}
int dlaf_symmetric_eigensolver_d(int ctx, char uplo, double* a,
                                 struct DLAF_descriptor desca, double* w,
                                 double* z, struct DLAF_descriptor descz) {
  return syevd_desc(ctx, uplo, a, desca, w, z, descz, "float64");
}
int dlaf_hermitian_eigensolver_c(int ctx, char uplo, void* a,
                                 struct DLAF_descriptor desca, float* w,
                                 void* z, struct DLAF_descriptor descz) {
  return syevd_desc(ctx, uplo, a, desca, w, z, descz, "complex64");
}
int dlaf_hermitian_eigensolver_z(int ctx, char uplo, void* a,
                                 struct DLAF_descriptor desca, double* w,
                                 void* z, struct DLAF_descriptor descz) {
  return syevd_desc(ctx, uplo, a, desca, w, z, descz, "complex128");
}

int dlaf_symmetric_generalized_eigensolver_s(
    int ctx, char uplo, float* a, struct DLAF_descriptor desca, float* b,
    struct DLAF_descriptor descb, float* w, float* z,
    struct DLAF_descriptor descz) {
  return sygvd_desc(ctx, uplo, a, desca, b, descb, w, z, descz, "float32", 0);
}
int dlaf_symmetric_generalized_eigensolver_d(
    int ctx, char uplo, double* a, struct DLAF_descriptor desca, double* b,
    struct DLAF_descriptor descb, double* w, double* z,
    struct DLAF_descriptor descz) {
  return sygvd_desc(ctx, uplo, a, desca, b, descb, w, z, descz, "float64", 0);
}
int dlaf_hermitian_generalized_eigensolver_c(
    int ctx, char uplo, void* a, struct DLAF_descriptor desca, void* b,
    struct DLAF_descriptor descb, float* w, void* z,
    struct DLAF_descriptor descz) {
  return sygvd_desc(ctx, uplo, a, desca, b, descb, w, z, descz, "complex64",
                    0);
}
int dlaf_hermitian_generalized_eigensolver_z(
    int ctx, char uplo, void* a, struct DLAF_descriptor desca, void* b,
    struct DLAF_descriptor descb, double* w, void* z,
    struct DLAF_descriptor descz) {
  return sygvd_desc(ctx, uplo, a, desca, b, descb, w, z, descz, "complex128",
                    0);
}
int dlaf_symmetric_generalized_eigensolver_factorized_s(
    int ctx, char uplo, float* a, struct DLAF_descriptor desca, float* b,
    struct DLAF_descriptor descb, float* w, float* z,
    struct DLAF_descriptor descz) {
  return sygvd_desc(ctx, uplo, a, desca, b, descb, w, z, descz, "float32", 1);
}
int dlaf_symmetric_generalized_eigensolver_factorized_d(
    int ctx, char uplo, double* a, struct DLAF_descriptor desca, double* b,
    struct DLAF_descriptor descb, double* w, double* z,
    struct DLAF_descriptor descz) {
  return sygvd_desc(ctx, uplo, a, desca, b, descb, w, z, descz, "float64", 1);
}
int dlaf_hermitian_generalized_eigensolver_factorized_c(
    int ctx, char uplo, void* a, struct DLAF_descriptor desca, void* b,
    struct DLAF_descriptor descb, float* w, void* z,
    struct DLAF_descriptor descz) {
  return sygvd_desc(ctx, uplo, a, desca, b, descb, w, z, descz, "complex64",
                    1);
}
int dlaf_hermitian_generalized_eigensolver_factorized_z(
    int ctx, char uplo, void* a, struct DLAF_descriptor desca, void* b,
    struct DLAF_descriptor descb, double* w, void* z,
    struct DLAF_descriptor descz) {
  return sygvd_desc(ctx, uplo, a, desca, b, descb, w, z, descz, "complex128",
                    1);
}

}  // extern "C"
