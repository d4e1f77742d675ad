"""Leaf (single-tile) kernels with dispatch.

PyTorch counterpart of :mod:`dlaf_tpu.ops.leaf`. Blocked recursions in
:mod:`dlaf_tpu_torch.ops.blocked` bottom out here on tiles of the leaf size.

Routes, by dtype first and device second:

  - f32/bf16 (the dtypes the TPU kernel takes) go to
    :func:`dlaf_tpu_torch.ops.kernels.potrf.potrf_tile`, which launches the
    Hopper kernel on a CUDA tensor and runs its plain version on a CPU
    tensor;
  - every other dtype takes the JAX package's non-Pallas route, here
    ``torch.linalg.cholesky_ex`` (the counterpart of
    ``jax.lax.linalg.cholesky``), through the same plain function.

Nothing catches a kernel failure: an error on the card propagates.
``trsm_leaf`` belongs to the local TRSM and is not ported yet.
"""
from __future__ import annotations

import torch

from .kernels.potrf import KERNEL_DTYPES, potrf_tile, potrf_tile_ref

_FORCE_BACKEND = None  # None = by dtype, "torch" = always the plain route


def set_leaf_backend(backend):
    """Force the leaf route: None (by dtype) or 'torch' (plain PyTorch even
    where the kernel would run, e.g. to time the plain route on the card)."""
    global _FORCE_BACKEND
    if backend not in (None, "torch"):
        raise ValueError(f"leaf backend must be None or 'torch', got {backend!r}")
    _FORCE_BACKEND = backend


def potrf_leaf(a: torch.Tensor, upper: bool = False) -> torch.Tensor:
    """Cholesky factor of a single SPD tile as a new tensor; the other
    triangle is zeroed. ``upper`` selects A = U^H U on the upper triangle."""
    if _FORCE_BACKEND is None and a.dtype in KERNEL_DTYPES:
        return potrf_tile(a, upper=upper)
    return potrf_tile_ref(a, upper=upper)
