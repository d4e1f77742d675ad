"""Machine-keyed build directory for the host-compiled libraries.

Counterpart of :mod:`dlaf_tpu.cache`. The JAX package keys XLA:CPU's
compile cache by the host's CPU features, because an executable built for
one CPU may crash on another; the port's host libraries
(:mod:`dlaf_tpu_torch.native`: the ScaLAPACK pack/unpack and host bulge
chase, built with ``-march=native``, and the C API's shim) have the same
property. They live under ``build/dlaf_tpu_torch/host-<key>/`` at the
repository root (``build/`` is not committed), ``<key>`` a hash of the
CPU's feature flags. The nvcc kernels stay where ``ops/kernels/_build.py``
puts them: they run on the card, not on the host's CPU.

This module imports no torch, so that any launcher can import it first.
"""
from __future__ import annotations

import hashlib
import platform
from pathlib import Path

REPO_BUILD = Path(__file__).resolve().parents[1] / "build" / "dlaf_tpu_torch"


def cpu_key() -> str:
    """A short hash of the host CPU's feature flags."""
    try:
        with open("/proc/cpuinfo") as f:
            key = next(line for line in f if line.startswith("flags"))
    except (OSError, StopIteration):
        key = platform.platform() + platform.processor()
    return hashlib.sha1(key.encode()).hexdigest()[:10]


def host_build_dir() -> Path:
    """The directory the host libraries of this machine are built into."""
    return REPO_BUILD / f"host-{cpu_key()}"
