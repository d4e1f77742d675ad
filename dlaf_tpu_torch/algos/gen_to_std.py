"""Generalized-to-standard eigenproblem transform (HEGST, itype=1).

PyTorch counterpart of :func:`dlaf_tpu.algos.gen_to_std.generalized_to_standard`
(reference ``dlaf::eigensolver::internal::GenToStd``,
``eigensolver/gen_to_std/impl.h:222``): A <- L^-1 A L^-H (lower) so that
the generalized problem A x = lambda B x becomes standard, as two blocked
left triangular solves. The distributed variant waits for
``DistMatrix.transpose``.
"""
from __future__ import annotations

import torch

from ..api.local import _leaf_nb, _pad_zero, _tri_operand
from ..ops import blocked
from ..ops.core import ct, hermitian_from_tri_


def generalized_to_standard(a: torch.Tensor, l: torch.Tensor, uplo: str = "L",
                            nb: int | None = None) -> torch.Tensor:
    """Return L^-1 A L^-H (uplo='L') or U^-H A U^-1 (uplo='U') as a new tensor.

    ``a`` hermitian (its ``uplo`` triangle is read), ``l`` the Cholesky
    factor of B on the same triangle (only that triangle is read). The first
    solve Y = L^-1 A runs in place in the padded hermitian copy of A; the
    second, L^-1 Y^H, in place in Y^H, which replaces it: A, L, Y and Y^H
    are the only full-size tensors.
    """
    if uplo not in ("L", "U"):
        raise ValueError(f"uplo must be 'L' or 'U', got {uplo!r}")
    nb = _leaf_nb(nb)
    n = a.shape[0]
    lower = uplo == "L"
    trans = "N" if lower else "C"
    lp = _tri_operand(l, nb, identity=True)
    y = hermitian_from_tri_(_pad_zero(a, nb), lower)
    blocked.trsm(y, lp, side="L", lower=lower, trans=trans, unit=False, nb=nb)
    y = ct(y).clone(memory_format=torch.contiguous_format)
    blocked.trsm(y, lp, side="L", lower=lower, trans=trans, unit=False, nb=nb)
    return y[:n, :n]
