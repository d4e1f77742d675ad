"""Generalized-to-standard eigenproblem transform (HEGST, itype=1).

PyTorch counterpart of :func:`dlaf_tpu.algos.gen_to_std.generalized_to_standard`
(reference ``dlaf::eigensolver::internal::GenToStd``,
``eigensolver/gen_to_std/impl.h:222``): A <- L^-1 A L^-H (lower) so that
the generalized problem A x = lambda B x becomes standard, as two blocked
left triangular solves; :func:`generalized_to_standard_dist` does the same
on a ``DistMatrix`` with the distributed solver and transpose.
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


def generalized_to_standard_dist(a, l, uplo: str = "L"):
    """Distributed variant over DistMatrix inputs, as a new DistMatrix:
    L^-1 A L^-H for ``uplo='L'``; U^-H A U^-1 for ``'U'``, with ``l``
    holding the upper factor U of B = U^H U, which is the lower case with
    L = U^H (one distributed conjugate transpose first; reference
    ``eigensolver/gen_to_std/impl.h:222,286``). ``a`` is the full
    hermitian matrix; ``l`` is padded with identity. Y = L^-1 A, then
    L^-1 Y^H: A, L, Y, Y^H and the result are the full-size tensors."""
    from .triangular import triangular_solver

    if uplo not in ("L", "U"):
        raise ValueError(f"uplo must be 'L' or 'U', got {uplo!r}")
    if uplo == "U":
        l = l.transpose()           # conjugate transpose: U^H is lower
    y = triangular_solver(l, a, uplo="L", trans="N")
    yt = y.transpose()
    del y
    return triangular_solver(l, yt, uplo="L", trans="N")
