"""LAPACK-flavored single-device API: local Cholesky.

PyTorch counterpart of ``potrf`` and ``potrf_info`` in
:mod:`dlaf_tpu.api.local` (reference ``dlaf::cholesky_factorization``,
``factorization/cholesky.h:40``). Arbitrary sizes are handled by padding
the matrix with an identity block up to a multiple of the leaf size. The
rest of the local API (TRSM, TRMM, HEMM, HERK, GEMM) is not ported yet.
"""
from __future__ import annotations

import torch

from ..ops import blocked
from ..tune import get_tune_parameters


def _leaf_nb(nb=None) -> int:
    return int(nb or get_tune_parameters().leaf_block_size)


def _pad_up(n: int, nb: int) -> int:
    return (-n) % nb


def _pad_tri_identity(a: torch.Tensor, nb: int) -> torch.Tensor:
    """A new working buffer: square ``a`` padded to a multiple of nb, with
    identity on the padded diagonal. This is the one copy of the input that
    the factorization then overwrites; ``a`` itself is never written."""
    n = a.shape[0]
    p = _pad_up(n, nb)
    if p == 0:
        return a.clone(memory_format=torch.contiguous_format)
    ap = a.new_zeros((n + p, n + p))
    ap[:n, :n] = a
    ap[n:, n:].fill_diagonal_(1)
    return ap


def potrf(a: torch.Tensor, uplo: str = "L", nb: int | None = None,
          clean: bool = True) -> torch.Tensor:
    """Cholesky factor of hermitian positive definite ``a`` (only the
    referenced triangle is read). With ``clean`` the other triangle is
    zeroed; without it it keeps the input (saves one full pass). The
    caller's tensor is not changed: the factor is computed in place in one
    padded copy, and the result is that copy (or its leading n x n view).

    ``a`` may lie on the CPU or on a CUDA device; on the card the f32/bf16
    leaves and the f32 upper trailing updates run the Hopper kernels.
    """
    if uplo not in ("L", "U"):
        raise ValueError(f"uplo must be 'L' or 'U', got {uplo!r}")
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"potrf needs a square matrix, got {tuple(a.shape)}")
    nb = _leaf_nb(nb)
    n = a.shape[0]
    work = _pad_tri_identity(a, nb)
    if uplo == "U":
        return blocked.potrf_upper(work, nb, clean=clean)[:n, :n]
    return blocked.potrf_lower(work, nb, clean=clean)[:n, :n]


def potrf_info(a: torch.Tensor, uplo: str = "L", nb: int | None = None,
               clean: bool = True):
    """Cholesky factor plus a LAPACK-style info channel: (factor, info).

    ``info`` is a 0-dim int32 tensor on the factor's device: 0 on success,
    else the 1-based index of the first column whose factor diagonal is
    non-positive or non-finite. A non-SPD pivot turns into NaN and
    propagates forward, so info identifies the failing pivot to within its
    leaf tile (the reference's ``potrfInfo`` is likewise per tile).
    """
    f = potrf(a, uplo=uplo, nb=nb, clean=clean)
    d = torch.diagonal(f).real
    bad = ~torch.isfinite(d) | (d <= 0)
    first = torch.argmax(bad.to(torch.int32)) + 1
    info = torch.where(bad.any(), first, torch.zeros_like(first)).to(torch.int32)
    return f, info
