"""LAPACK-flavored single-device API.

PyTorch counterpart of :mod:`dlaf_tpu.api.local`: the local variants of the
reference's algorithm free functions (``dlaf::cholesky_factorization``
``factorization/cholesky.h:40``, ``dlaf::triangular_solver``
``solver/triangular.h``, ``dlaf::triangular_multiplication``,
``dlaf::hermitian_multiplication``, ``multiplication/general.h``).

Arbitrary sizes are handled by tile-aligned padding: POTRF/TRSM pad the
triangular operand with an identity block, TRMM zero-pads; HERK, HEMM and
GEMM take any size. Each function computes in place in one working buffer
that it allocates (the padded copy of the operand it overwrites) and
returns that buffer or its leading view; the caller's tensors are never
written.
"""
from __future__ import annotations

import torch

from ..ops import blocked
from ..ops.core import mm
from ..tune import get_tune_parameters
from ..types import Trans


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


def _pad_zero(a: torch.Tensor, nb: int) -> torch.Tensor:
    """A new working buffer: ``a`` zero-padded to multiples of nb in both
    dimensions."""
    m, n = a.shape
    out = a.new_zeros((m + _pad_up(m, nb), n + _pad_up(n, nb)))
    out[:m, :n] = a
    return out


def _tri_operand(a: torch.Tensor, nb: int, identity: bool) -> torch.Tensor:
    """A triangular operand that is only read: ``a`` itself where its order
    is a multiple of nb, else its padded copy (identity or zeros on the
    padded diagonal)."""
    if _pad_up(a.shape[0], nb) == 0:
        return a
    return _pad_tri_identity(a, nb) if identity else _pad_zero(a, nb)


def _check_square(what: str, a: torch.Tensor) -> None:
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"{what} needs a square matrix, got {tuple(a.shape)}")


def _check_uplo(uplo: str) -> None:
    if uplo not in ("L", "U"):
        raise ValueError(f"uplo must be 'L' or 'U', got {uplo!r}")


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
    _check_uplo(uplo)
    _check_square("potrf", a)
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


def trsm(a: torch.Tensor, b: torch.Tensor, side: str = "L", uplo: str = "L",
         trans: str = "N", diag: str = "N", alpha=1.0, nb: int | None = None) -> torch.Tensor:
    """Solve op(A) X = alpha B or X op(A) = alpha B, A triangular (only its
    ``uplo`` triangle is read, and with ``diag='U'`` not its diagonal).

    Reference: ``dlaf::triangular_solver`` (``solver/triangular.h``), all 8
    side/uplo/trans cases plus unit diagonal. X is computed in place in a
    zero-padded copy of B; A is padded with identity where its order is not
    a multiple of the leaf size. bf16 is refused (see ``ops/leaf.py``).
    """
    _check_uplo(uplo)
    _check_square("trsm", a)
    nb = _leaf_nb(nb)
    m, n = b.shape
    x = _pad_zero(b, nb)
    blocked.trsm(x, _tri_operand(a, nb, identity=True), side=side, lower=(uplo == "L"),
                 trans=trans, unit=(diag == "U"), nb=nb, alpha=alpha)
    return x[:m, :n]


def trmm(a: torch.Tensor, b: torch.Tensor, side: str = "L", uplo: str = "L",
         trans: str = "N", diag: str = "N", alpha=1.0, nb: int | None = None) -> torch.Tensor:
    """B <- alpha op(A) B or alpha B op(A), A triangular, as a new tensor.

    Reference: ``dlaf::triangular_multiplication`` (``multiplication/triangular.h``).
    """
    _check_uplo(uplo)
    _check_square("trmm", a)
    nb = _leaf_nb(nb)
    m, n = b.shape
    y = _pad_zero(b, nb)
    blocked.trmm(y, _tri_operand(a, nb, identity=False), side=side, lower=(uplo == "L"),
                 trans=trans, unit=(diag == "U"), nb=nb, alpha=alpha)
    return y[:m, :n]


def hemm(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor | None = None, side: str = "L",
         uplo: str = "L", alpha=1.0, beta=0.0) -> torch.Tensor:
    """alpha A B + beta C (or alpha B A + beta C), A hermitian
    (triangle-stored), as a new tensor.

    Reference: ``dlaf::hermitian_multiplication`` (``multiplication/hermitian.h``).
    """
    _check_uplo(uplo)
    if c is None:
        out, beta = b.new_zeros(b.shape), 0.0
    else:
        out = c.clone(memory_format=torch.contiguous_format)
    return blocked.hemm(out, a, b, side=side, lower=(uplo == "L"), alpha=alpha, beta=beta)


def herk(a: torch.Tensor, c: torch.Tensor, uplo: str = "L", trans: str = "N", alpha=1.0,
         beta=1.0) -> torch.Tensor:
    """alpha op(A) op(A)^H + beta C on the referenced triangle of C, as a new
    tensor (the other triangle keeps C's). In f32 on the card, uplo 'U',
    trans 'C', alpha -1 and beta 1 runs the off-diagonal blocks through K2
    (under ``potrf_trailing_kernel="kernel"``)."""
    _check_uplo(uplo)
    out = c.clone(memory_format=torch.contiguous_format)
    # K2 takes operands of unit column stride (a no-op for a contiguous a)
    return blocked.herk(out, a.contiguous(), lower=(uplo == "L"), trans=trans, alpha=alpha,
                        beta=beta, nb=_leaf_nb())


def gemm(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor | None = None, transa: str = "N",
         transb: str = "N", alpha=1.0, beta=0.0) -> torch.Tensor:
    """alpha op(A) op(B) + beta C as a new tensor (reference
    ``multiplication/general.h:52``); without ``c``, alpha op(A) op(B)."""
    if c is None:
        return alpha * mm(a, b, ta=Trans(transa), tb=Trans(transb))
    out = c.clone(memory_format=torch.contiguous_format)
    return blocked.gemm(out, a, b, transa=transa, transb=transb, alpha=alpha, beta=beta)
