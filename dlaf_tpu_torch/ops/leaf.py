"""Leaf (single-tile) kernels with dispatch.

PyTorch counterpart of :mod:`dlaf_tpu.ops.leaf`. Blocked recursions in
:mod:`dlaf_tpu_torch.ops.blocked` bottom out here on tiles of the leaf size.

Routes, by dtype first and device second:

  - ``potrf_leaf``: f32/bf16 (the dtypes the TPU kernel takes) go to
    :func:`dlaf_tpu_torch.ops.kernels.potrf.potrf_tile`, which launches the
    Hopper kernel on a CUDA tensor and runs its plain version on a CPU
    tensor; every other dtype takes the JAX package's non-Pallas route,
    here ``torch.linalg.cholesky_ex`` (the counterpart of
    ``jax.lax.linalg.cholesky``), through the same plain function.
  - ``trsm_leaf``: f32 takes the TPU route's function, :func:`trsm_tile`
    (the tile's inverse by blocked recursion, then one GEMM; it reaches no
    Pallas kernel, so it stays torch ops on every device); every other
    dtype takes ``torch.linalg.solve_triangular``, the counterpart of
    ``jax.lax.linalg.triangular_solve``. bf16 is refused: the card has no
    bf16 triangular solve, which the tile inverse needs.

``set_leaf_backend("torch")`` forces the second route of both, e.g. to
time the plain or library route on the card. Nothing catches a kernel
failure: an error on the card propagates.
"""
from __future__ import annotations

import torch

from .core import op_mat
from .householder import tri_inv
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


def trsm_tile(a: torch.Tensor, b: torch.Tensor, *, left: bool, lower: bool, trans: str,
              unit: bool) -> torch.Tensor:
    """Solve op(a) x = b (left) or x op(a) = b (right) for one tile, as a new
    tensor: the unit diagonal set to 1, the triangle inverted
    (:func:`tri_inv`, nb = 64), op() of the inverse, then one GEMM
    (``dlaf_tpu/ops/pallas/trsm.py`` ``trsm_tile``)."""
    if unit:
        a = a.clone()
        a.diagonal().fill_(1)
    inv = op_mat(tri_inv(a, lower=lower, nb=64), trans)
    return inv @ b if left else b @ inv


def trsm_leaf(a: torch.Tensor, b: torch.Tensor, *, left: bool, lower: bool, trans: str,
              unit: bool) -> torch.Tensor:
    """Solve op(a) x = b (left) or x op(a) = b (right) on a single tile; only
    the ``lower`` (or upper) triangle of ``a`` is read, and with ``unit``
    not its diagonal. Returns a new tensor."""
    if a.dtype == torch.bfloat16:
        raise TypeError("trsm takes no bfloat16: the tile solve has no bfloat16 kernel "
                        "on the card (solve_triangular)")
    if _FORCE_BACKEND is None and a.dtype == torch.float32:
        return trsm_tile(a, b, left=left, lower=lower, trans=trans, unit=unit)
    # op(a) of a lower triangle is upper for T and C
    upper = (not lower) if trans == "N" else lower
    return torch.linalg.solve_triangular(op_mat(a, trans), b, upper=upper, left=left,
                                         unitriangular=unit)
