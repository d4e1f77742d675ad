"""Python half of the C API (see dlaf_tpu_c.h / dlaf_c_api.cpp).

Counterpart of :mod:`dlaf_tpu.native.c_entry`. The embedded interpreter
calls these with raw buffer addresses; all numpy buffer wrapping happens
here, so the C shim stays a thin dispatcher (reference split:
src/c_api/*.cpp over the C++ library).

Caller buffers are ScaLAPACK-style column-major with leading dimension
lld = desca[8]; they are wrapped zero-copy with an order='F' reshape and
results are copied back through the same view.

The device is ``DLAF_TPU_TORCH_DEVICE``: "cuda" (the default; each rank on
``cuda:{rank % device_count}``, and :func:`c_initialize` fails where no
CUDA device is present) or "cpu". :func:`c_initialize` joins the process
group that the environment describes when ``WORLD_SIZE`` > 1 (one process
per rank, as the reference's MPI callers run).
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

DEVICE_ENV = "DLAF_TPU_TORCH_DEVICE"


def device() -> str:
    """The device the C caller asked for (``DLAF_TPU_TORCH_DEVICE``)."""
    dev = os.environ.get(DEVICE_ENV, "cuda").strip().lower() or "cuda"
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"{DEVICE_ENV} must be 'cuda' or 'cpu', got {dev!r}")
    return dev


def c_initialize() -> int:
    from .. import init
    init.initialize(distributed=int(os.environ.get("WORLD_SIZE", "1")) > 1, device=device())
    return 0


def c_finalize() -> int:
    from .. import init
    from ..api import scalapack as s
    s.dlaf_free_all_grids()
    init.finalize()
    return 0


def _wrap(ptr: int, count: int, dtype) -> np.ndarray:
    buf = (ctypes.c_char * (count * np.dtype(dtype).itemsize)).from_address(ptr)
    return np.frombuffer(buf, dtype=dtype)


def _global_view(aptr: int, desca, dtype) -> np.ndarray:
    m, n, lld = desca[2], desca[3], desca[8]
    flat = _wrap(aptr, lld * n, dtype)
    return flat.reshape((lld, n), order="F")[:m, :]


def c_create_grid(nprow: int, npcol: int, order: str = "R") -> int:
    from ..api import scalapack as s
    if order not in ("R", "C"):
        return -2
    return s.dlaf_create_grid(nprow, npcol, order)


def c_free_grid(ctx: int) -> int:
    from ..api import scalapack as s
    s.dlaf_free_grid(ctx)
    return 0


def c_ppotrf(uplo: str, n: int, aptr: int, ia: int, ja: int, desca, ctx: int,
             dt: str) -> int:
    from ..api import scalapack as s
    a = _global_view(aptr, desca, np.dtype(dt))
    fn = {"float32": s.dlaf_pspotrf, "float64": s.dlaf_pdpotrf,
          "complex64": s.dlaf_pcpotrf, "complex128": s.dlaf_pzpotrf}[dt]
    out = fn(uplo, n, np.ascontiguousarray(a), ia, ja, list(desca), ctx, device=device())
    # LAPACK-style info: first non-finite diagonal entry of the factor
    # marks the non-SPD leading minor (header contract, dlaf_tpu_c.h), on
    # the submatrix diagonal (ia-1+t, ja-1+t), not the main diagonal
    t = np.arange(n)
    bad = ~np.isfinite(out[ia - 1 + t, ja - 1 + t])
    if bad.any():
        return int(np.argmax(bad)) + 1
    np.copyto(a, out)
    return 0


def _wdtype(dt: str) -> np.dtype:
    """Eigenvalue dtype: the real base type of ``dt``."""
    return np.dtype({"complex64": "float32", "complex128": "float64"}.get(dt, dt))


def c_psygvd(uplo: str, n: int, aptr: int, ia: int, ja: int, desca,
             bptr: int, ib: int, jb: int, descb, wptr: int, zptr: int,
             ctx: int, dt: str, factorized: int) -> int:
    """ScaLAPACK-style generalized eigensolver (header contract:
    dlaf_p{s,d}sygvd / dlaf_p{c,z}hegvd [+_factorized]); w gets n REAL
    eigenvalues, z is written compact n x n column-major."""
    from ..api import scalapack as s
    dtype = np.dtype(dt)
    a = _global_view(aptr, desca, dtype)
    b = _global_view(bptr, descb, dtype)
    base = {"float32": "dlaf_pssygvd", "float64": "dlaf_pdsygvd",
            "complex64": "dlaf_pchegvd", "complex128": "dlaf_pzhegvd"}[dt]
    fn = getattr(s, base + ("_factorized" if factorized else ""))
    w, z = fn(uplo, n, np.ascontiguousarray(a), np.ascontiguousarray(b),
              ia, ja, list(desca), ctx, ib=ib, jb=jb, descb=list(descb), device=device())
    np.copyto(_wrap(wptr, n, _wdtype(dt)), np.asarray(w, _wdtype(dt)))
    zv = _wrap(zptr, n * n, dtype).reshape((n, n), order="F")
    np.copyto(zv, np.asarray(z, dtype))
    return 0


# ---------------------------------------------------------------------------
# descriptor-based entries (header struct DLAF_descriptor, reference
# include/dlaf_c/desc.h:16): d arrives as the 9-tuple
# (m, n, mb, nb, isrc, jsrc, i, j, ld); ld is the leading dimension of the
# GLOBAL column-major buffer (0 means m), i/j must be 0.


def _dlaf_view(ptr: int, d, dtype) -> np.ndarray:
    m, n, ld = d[0], d[1], d[8] or d[0]
    flat = _wrap(ptr, ld * n, dtype)
    return flat.reshape((ld, n), order="F")[:m, :]


def _dlaf_desc(d):
    from ..api import scalapack as s
    return s.DLAF_descriptor(m=d[0], n=d[1], mb=d[2], nb=d[3],
                             isrc=d[4], jsrc=d[5], ld=d[8])


def c_chol_desc(ctx: int, uplo: str, aptr: int, d, dt: str) -> int:
    from ..api import scalapack as s
    if d[6] != 0 or d[7] != 0:
        return -2  # submatrix offsets unsupported (reference: must be 0)
    a = _dlaf_view(aptr, d, np.dtype(dt))
    out = s.dlaf_cholesky_factorization(ctx, uplo, np.ascontiguousarray(a),
                                        _dlaf_desc(d), device=device())
    bad = ~np.isfinite(np.diagonal(out))
    if bad.any():
        return int(np.argmax(bad)) + 1
    np.copyto(a, out)
    return 0


def c_syevd_desc(ctx: int, uplo: str, aptr: int, da, wptr: int, zptr: int,
                 dz, dt: str) -> int:
    from ..api import scalapack as s
    if da[6] or da[7] or dz[6] or dz[7]:
        return -2
    dtype = np.dtype(dt)
    a = _dlaf_view(aptr, da, dtype)
    w, z = s.dlaf_symmetric_eigensolver(ctx, uplo, np.ascontiguousarray(a),
                                        _dlaf_desc(da), device=device())
    np.copyto(_wrap(wptr, da[0], _wdtype(dt)), np.asarray(w, _wdtype(dt)))
    np.copyto(_dlaf_view(zptr, dz, dtype), np.asarray(z, dtype))
    return 0


def c_sygvd_desc(ctx: int, uplo: str, aptr: int, da, bptr: int, db,
                 wptr: int, zptr: int, dz, dt: str, factorized: int) -> int:
    from ..api import scalapack as s
    if da[6] or da[7] or db[6] or db[7] or dz[6] or dz[7]:
        return -2
    if (da[2], da[3]) != (db[2], db[3]):
        return -3  # a and b must share the blocking factors
    dtype = np.dtype(dt)
    a = _dlaf_view(aptr, da, dtype)
    b = _dlaf_view(bptr, db, dtype)
    w, z = s.dlaf_symmetric_generalized_eigensolver(
        ctx, uplo, np.ascontiguousarray(a), np.ascontiguousarray(b),
        _dlaf_desc(da), factorized=bool(factorized), device=device())
    np.copyto(_wrap(wptr, da[0], _wdtype(dt)), np.asarray(w, _wdtype(dt)))
    np.copyto(_dlaf_view(zptr, dz, dtype), np.asarray(z, dtype))
    return 0


def c_psyevd(uplo: str, n: int, aptr: int, desca, wptr: int, zptr: int,
             ctx: int, dt: str) -> int:
    from ..api import scalapack as s
    dtype = np.dtype(dt)
    a = _global_view(aptr, desca, dtype)
    fn = {"float32": s.dlaf_pssyevd, "float64": s.dlaf_pdsyevd,
          "complex64": s.dlaf_pcheevd, "complex128": s.dlaf_pzheevd}[dt]
    w, z = fn(uplo, n, np.ascontiguousarray(a), 1, 1, list(desca), ctx, device=device())
    np.copyto(_wrap(wptr, n, _wdtype(dt)), np.asarray(w, _wdtype(dt)))
    # z is a compact n x n column-major buffer per the header contract
    # (NOT lld-strided like a — writing with desca's lld would overrun it)
    zv = _wrap(zptr, n * n, dtype).reshape((n, n), order="F")
    np.copyto(zv, np.asarray(z, dtype))
    return 0
