"""Build and load the hand-written Hopper kernels of ``dlaf_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
alone (no PyTorch headers) into its own shared library under
``build/dlaf_tpu_torch/`` at the repository root, at first use. A library's
file name carries a hash of its source and of the flags, so an edited source
is rebuilt and an unchanged one is reused. All missing libraries are built
together, one ``nvcc`` process per source. Nothing else is built and
nothing is downloaded.

The libraries are loaded with ``ctypes``. Every pointer and the stream are
declared ``c_void_p``; each C entry point launches on the stream it is given
and returns ``cudaGetLastError()``, which :func:`check` turns into an
exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "dlaf_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# library -> {C entry point: argtypes}; every entry returns a cudaError_t
SIGNATURES = {
    "potrf_tile": {
        # a, lda, out, ldo, work, nb, upper, bf16, stream
        "dlaf_potrf_tile": [_P, _LL, _P, _LL, _P, _I, _I, _I, _P],
        # nb, bf16, out (int[4]: resident, smem bytes, cluster blocks, clusters)
        "dlaf_potrf_tile_plan": [_I, _I, _P],
    },
    "ksub_tf32x3": {
        # c, ldc, x, ldx, y, ldy, m, n, k, x_k_major, stream
        "dlaf_ksub_tf32x3": [_P, _LL, _P, _LL, _P, _LL, _I, _I, _I, _I, _P],
        # K6: c, ldc, x, ldx, y, ldy, grow, gcol (int32), m, n, k, x_k_major, stream,
        # pipelined (int out: 1 where the call took the pipelined route)
        "dlaf_ksub_tf32x3_masked": [_P, _LL, _P, _LL, _P, _LL, _P, _P, _I, _I, _I, _I, _P, _P],
        # x, ldx, y, ldy, m, n, k, out (int[2]: 16-byte copies, k split)
        "dlaf_ksub_tf32x3_plan": [_P, _LL, _P, _LL, _I, _I, _I, _P],
    },
    "band2tridiag": {
        # strips, vs, taus, done (int32 a lane), n, b, nrec, sweep_lo, is_complex, stream
        "dlaf_band2tridiag": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        # n, b, is_complex, out (int[4]: lanes, grid, resident, shared memory bytes)
        "dlaf_band2tridiag_plan": [_I, _I, _I, _P],
    },
    "bt_apply": {
        # e, ld, nev, v, v2t, b, base, ncvalid, stream
        "dlaf_bt_apply_group": [_P, _LL, _I, _P, _P, _I, _I, _I, _P],
        # e, ld, nev, v, v2t, b, k, beta, nact, v0p, stream
        "dlaf_bt_apply_fused": [_P, _LL, _I, _P, _P, _I, _I, _I, _I, _I, _P],
    },
}

_libs: dict = {}
build_log: dict = {}   # library -> {"seconds": float, "ptxas": str (registers, spills)}


def on_cuda(t: torch.Tensor) -> bool:
    """The device probe every wrapper dispatches on: True for a CUDA tensor
    (launch the kernel or raise), False for a CPU tensor (plain version).
    Any other device is refused."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no route for a tensor on {t.device}")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the Hopper kernels are built from source at first use")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Build every library whose file is missing, all nvcc runs at once.
    Returns :data:`build_log`; raises with nvcc's output on any failure."""
    todo = [n for n in SIGNATURES if not _target(n).exists()]
    if not todo:
        return build_log
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = _target(name).with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{out}")
            continue
        os.replace(tmp, _target(name))
        build_log[name] = {"seconds": time.perf_counter() - t0,
                           "ptxas": " | ".join(l.strip() for l in out.splitlines()
                                               if "ptxas info" in l or "spill" in l)}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return build_log


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built first if missing)."""
    lib = _libs.get(name)
    if lib is None:
        if not _target(name).exists():
            build_all()
        lib = ctypes.CDLL(str(_target(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.dlaf_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dlaf_cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(rc: int, lib: ctypes.CDLL, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        msg = lib.dlaf_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
