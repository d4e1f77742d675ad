"""Triangular inverse of a factored diagonal tile.

PyTorch counterpart of ``tri_inv`` in :mod:`dlaf_tpu.ops.householder`. The
rest of that module (Householder vectors, panel QR, T factors) belongs to
the eigensolver and is not ported yet.
"""
from __future__ import annotations

import torch

from .core import mm


def tri_inv(a: torch.Tensor, lower: bool = True, nb: int = 64) -> torch.Tensor:
    """Inverse of a triangular matrix by blocked recursion:
    inv([[A,0],[B,C]]) = [[iA,0],[-iC B iA, iC]]. Only the ``lower`` (or
    upper) triangle of ``a`` is read; the result is a new tensor."""
    n = a.shape[0]
    if n <= nb:
        eye = torch.eye(n, dtype=a.dtype, device=a.device)
        return torch.linalg.solve_triangular(a, eye, upper=not lower)
    n1 = max(n // (2 * nb), 1) * nb
    out = torch.zeros_like(a)
    ia = tri_inv(a[:n1, :n1], lower, nb)
    ic = tri_inv(a[n1:, n1:], lower, nb)
    out[:n1, :n1] = ia
    out[n1:, n1:] = ic
    if lower:
        out[n1:, :n1] = -mm(ic, mm(a[n1:, :n1], ia))
    else:
        out[:n1, n1:] = -mm(ia, mm(a[:n1, n1:], ic))
    return out
