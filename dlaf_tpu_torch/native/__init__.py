"""Host C++ of the port, built with g++ at first use.

Counterpart of :mod:`dlaf_tpu.native`. ``dlaf_native.cpp`` (a copy of the
JAX package's) holds the ScaLAPACK local-layout ``pack_local`` /
``unpack_local`` and the host bulge chase ``band_to_tridiag_host``;
``dlaf_c_api.cpp`` is the C API's shim (:func:`build_c_api`). Both are
built into the machine-keyed directory of :mod:`dlaf_tpu_torch.cache`,
each library's file name carrying a hash of its sources and flags, so that
an edited source is rebuilt and an unchanged one reused. A failed build
raises with the compiler's output: nothing falls back on another route.

``pack_local`` and ``unpack_local`` take the library for f32/f64 arrays in
the layouts it was written for (a C-contiguous global array, a
Fortran-contiguous local one) and their NumPy loops, the plain versions,
for every other dtype and layout, as the JAX package dispatches them.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import sys
import sysconfig
from pathlib import Path

import numpy as np

from ..cache import host_build_dir
from ..dist import index as ix

HERE = Path(__file__).resolve().parent
# the directory that holds the dlaf_tpu_torch package (the repository root)
PACKAGE_PARENT = HERE.parents[1]
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")
C_API_NAME = "dlaf_tpu_torch_c"

_lib = None


def _digest(*parts: bytes) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p)
    return h.hexdigest()[:16]


def _run_cxx(cmd, target: Path) -> Path:
    """Run the compiler into a temporary file, then move it to ``target``
    (so that processes that build at once never load half a library)."""
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.tmp{os.getpid()}")
    r = subprocess.run([*cmd, "-o", str(tmp)], capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"building {target.name} failed:\n{' '.join(cmd)}\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, target)
    return target


def build_native() -> Path:
    """Build (if missing) and return the path of ``libdlaf_native``."""
    src = HERE / "dlaf_native.cpp"
    cxx = os.environ.get("CXX", "g++")
    key = _digest(src.read_bytes(), " ".join(CXXFLAGS).encode(), cxx.encode())
    target = host_build_dir() / f"libdlaf_native-{key}.so"
    if target.exists():
        return target
    return _run_cxx([cxx, *CXXFLAGS, str(src)], target)


_P = ctypes.c_void_p
_I = ctypes.c_int64
# entry point -> argtypes (every one returns void)
_SIGNATURES = {
    # g, m, n, mb, nb, P, Q, p, q, isrc, jsrc, loc, lld
    "pack_local": [_P] + [_I] * 10 + [_P, _I],
    # loc, m, n, mb, nb, P, Q, p, q, isrc, jsrc, g, lld
    "unpack_local": [_P] + [_I] * 10 + [_P, _I],
    # a, n, b, d, e, vs, taus, ncmax
    "band_to_tridiag": [_P, _I, _I, _P, _P, _P, _P, _I],
}


def _native() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_native()))
        for name, args in _SIGNATURES.items():
            for sfx in ("f32", "f64"):
                fn = getattr(lib, f"{name}_{sfx}")
                fn.argtypes, fn.restype = args, None
        _lib = lib
    return _lib


def _python_link_flags() -> list:
    """Include and link flags of this interpreter, from ``sysconfig``."""
    cfg = sysconfig.get_config_var
    libname = cfg("LDLIBRARY")
    if not libname or not libname.startswith("lib") or ".so" not in libname:
        raise RuntimeError("the C API embeds a shared libpython; this interpreter has "
                           f"{libname!r}")
    libdirs = [d for d in (cfg("LIBDIR"), cfg("LIBPL")) if d]
    return ([f"-I{cfg('INCLUDEPY')}"] + [f"-L{d}" for d in libdirs] +
            [f"-Wl,-rpath,{d}" for d in libdirs] + [f"-l{libname[3:].split('.so')[0]}", "-ldl"])


def build_c_api() -> Path:
    """Build (if missing) and return the path of the C API's shared library
    ``lib{C_API_NAME}.so`` (header: ``dlaf_tpu_c.h`` in this directory).

    The embedded interpreter must import this package and torch whatever
    program loads the library, so the build records this interpreter's
    ``sys.path`` and the package's root in a generated header: a C program
    that embeds libpython gets its path from libpython's prefix alone,
    which misses a virtual environment's site-packages."""
    src, hdr = HERE / "dlaf_c_api.cpp", HERE / "dlaf_tpu_c.h"
    config = ("// generated by dlaf_tpu_torch.native.build_c_api\n"
              f"#define DLAF_PACKAGE_ROOT {json.dumps(str(PACKAGE_PARENT))}\n"
              f"#define DLAF_SYS_PATH {json.dumps(json.dumps([p for p in sys.path if p]))}\n")
    flags = ["-O2", "-fPIC", "-std=c++17", "-Wall", "-shared", *_python_link_flags()]
    cxx = os.environ.get("CXX", "g++")
    key = _digest(src.read_bytes(), hdr.read_bytes(), config.encode(), " ".join(flags).encode(),
                  cxx.encode())
    out_dir = host_build_dir() / f"c_api-{key}"
    target = out_dir / f"lib{C_API_NAME}.so"
    if target.exists():
        return target
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg_path = out_dir / f"dlaf_c_api_config.h.tmp{os.getpid()}"
    cfg_path.write_text(config)
    os.replace(cfg_path, out_dir / "dlaf_c_api_config.h")
    # the compiler and linker flags go after the source (the -l order matters)
    return _run_cxx([cxx, f"-I{HERE}", f"-I{out_dir}", str(src), *flags], target)


def _ptr(a):
    return a.ctypes.data_as(_P)


_SUFFIX = {"float32": "f32", "float64": "f64"}


def pack_local(g: np.ndarray, mb: int, nb: int, grid, rank, src=(0, 0)):
    """Global (m, n) row-major -> rank (p, q)'s ScaLAPACK local (column-major)."""
    m, n = g.shape
    P, Q = grid
    p, q = rank
    lm = int(ix.local_size(m, mb, P, p, src[0]))
    ln = int(ix.local_size(n, nb, Q, q, src[1]))
    loc = np.zeros((ln, lm), g.dtype).T  # column-major (lm, ln)
    sfx = _SUFFIX.get(g.dtype.name)
    if sfx and g.flags.c_contiguous:
        getattr(_native(), f"pack_local_{sfx}")(
            _ptr(g), _I(m), _I(n), _I(mb), _I(nb), _I(P), _I(Q), _I(p), _I(q),
            _I(src[0]), _I(src[1]), _ptr(loc), _I(lm))
        return loc
    for gi in range(ix.ceil_div(m, mb)):
        if (gi + src[0]) % P != p:
            continue
        li = gi // P
        for gj in range(ix.ceil_div(n, nb)):
            if (gj + src[1]) % Q != q:
                continue
            lj = gj // Q
            blk = g[gi * mb:(gi + 1) * mb, gj * nb:(gj + 1) * nb]
            loc[li * mb:li * mb + blk.shape[0], lj * nb:lj * nb + blk.shape[1]] = blk
    return loc


def unpack_local(loc: np.ndarray, m: int, n: int, mb: int, nb: int, grid, rank,
                 out: np.ndarray, src=(0, 0)):
    """Inverse of :func:`pack_local`, writing rank (p, q)'s tiles into
    ``out`` (m, n) row-major; returns ``out``."""
    P, Q = grid
    p, q = rank
    lm = int(ix.local_size(m, mb, P, p, src[0]))
    ln = int(ix.local_size(n, nb, Q, q, src[1]))
    if out.shape != (m, n) or loc.shape[0] < lm or loc.shape[1] < ln:
        raise ValueError(f"unpack_local: out {out.shape} must be ({m}, {n}) and loc "
                         f"{loc.shape} at least ({lm}, {ln})")
    sfx = _SUFFIX.get(out.dtype.name)
    if sfx and out.dtype == loc.dtype and out.flags.c_contiguous and loc.flags.f_contiguous:
        getattr(_native(), f"unpack_local_{sfx}")(
            _ptr(loc), _I(m), _I(n), _I(mb), _I(nb), _I(P), _I(Q), _I(p), _I(q),
            _I(src[0]), _I(src[1]), _ptr(out), _I(loc.shape[0]))
        return out
    for gi in range(ix.ceil_div(m, mb)):
        if (gi + src[0]) % P != p:
            continue
        li = gi // P
        for gj in range(ix.ceil_div(n, nb)):
            if (gj + src[1]) % Q != q:
                continue
            lj = gj // Q
            r1 = min((gi + 1) * mb, m) - gi * mb
            c1 = min((gj + 1) * nb, n) - gj * nb
            out[gi * mb:gi * mb + r1, gj * nb:gj * nb + c1] = \
                loc[li * mb:li * mb + r1, lj * nb:lj * nb + c1]
    return out


def band_to_tridiag_host(band_dense: np.ndarray, b: int):
    """Host bulge chase of a dense symmetric band matrix (bandwidth ``b``)
    to tridiagonal form with the reflector record, f32 or f64 (the
    reference keeps this stage on the CPU, ``band_to_tridiag/api.h:37-42``).
    Returns (d, e, vs (nsweeps, ncmax, b), taus (nsweeps, ncmax))."""
    a = np.ascontiguousarray(band_dense).copy()
    n = a.shape[0]
    dt = a.dtype
    sfx = _SUFFIX.get(dt.name)
    if sfx is None:
        raise ValueError(f"band_to_tridiag_host takes float32 or float64, got {dt}")
    ncmax = max(-(-(n - 1) // b), 1)
    nsweeps = max(n - 2, 1)
    d = np.zeros(n, dt)
    e = np.zeros(max(n - 1, 1), dt)
    vs = np.zeros((nsweeps, ncmax, b), dt)
    taus = np.zeros((nsweeps, ncmax), dt)
    getattr(_native(), f"band_to_tridiag_{sfx}")(
        _ptr(a), _I(n), _I(b), _ptr(d), _ptr(e), _ptr(vs), _ptr(taus), _I(ncmax))
    return d, e[: n - 1] if n > 1 else e[:0], vs, taus
