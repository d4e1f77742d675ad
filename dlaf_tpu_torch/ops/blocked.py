"""Blocked recursive POTRF building blocks (single device).

PyTorch counterpart of the POTRF part of :mod:`dlaf_tpu.ops.blocked`
(``_split``, ``potrf_lower``, ``potrf_upper``, the two pre-inverted panel
solves and ``_herk_inplace``). The recursion is the same static
tile-aligned halving; what JAX writes as functional ``.at[].set`` updates
are in-place writes into the one working buffer here: every function below
modifies the tensor it is given (a view into that buffer) and returns it.
Block updates of the form C <- beta C + alpha op(A) op(B) are one
``addmm_`` into the view, so the plain route allocates no product.

All functions require dimensions to be multiples of the leaf size ``nb``
(the public API pads, see :mod:`dlaf_tpu_torch.api.local`), are dtype
generic, and follow BLAS semantics for which triangle is read and written.
The rest of the JAX module (TRSM, TRMM, HERK, HER2K, HEMM, GEMM) is not
ported yet.
"""
from __future__ import annotations

import torch

from ..tune import get_tune_parameters
from ..types import Trans
from .core import ct, mm, op_mat, set_tri
from .householder import tri_inv
from .kernels.trailing import ksub_available, ksub_matmul
from .leaf import potrf_leaf


def _split(n: int, nb: int) -> int:
    """Largest tile-aligned split point <= n/2 (at least one tile)."""
    return max(n // (2 * nb), 1) * nb


def _check_tiled(a: torch.Tensor, nb: int) -> int:
    n = a.shape[0]
    if a.shape != (n, n) or n % nb:
        raise ValueError(f"need a square matrix tiled by nb={nb}, got {tuple(a.shape)}")
    return n


def potrf_lower(a: torch.Tensor, nb: int, clean: bool = True) -> torch.Tensor:
    """Lower Cholesky of SPD ``a``, in place.

    With ``clean`` the strictly-upper part is zeroed; without it the upper
    triangle keeps the input (the reference's in-place semantics). Each
    diagonal tile is inverted once when it is factored, and every panel
    solve below it is a GEMM against that inverse.
    """
    n = _check_tiled(a, nb)
    invd = a.new_zeros((n // nb, min(nb, n), min(nb, n)))

    def rec(o, s):
        if s <= nb:
            f = potrf_leaf(a[o:o + s, o:o + s])
            a[o:o + s, o:o + s] = f
            invd[o // nb] = tri_inv(f, lower=True, nb=64)
            return
        s1 = _split(s, nb)
        rec(o, s1)
        # A21 <- A21 L11^-H
        l21 = _trsm_right_lc_preinv(a[o + s1:o + s, o:o + s1], a, invd, o, s1, nb)
        # A22 <- A22 - L21 L21^H
        _herk_inplace(a, o + s1, s - s1, l21, lower=True, trans="N",
                      alpha=-1.0, beta=1.0, nb=nb)
        rec(o + s1, s - s1)

    rec(0, n)
    return a.tril_() if clean else a


def _trsm_right_lc_preinv(b, a, invd, o, s, nb):
    """X L^H = B in place, L = a[o:o+s, o:o+s] (lower, factored), each
    diagonal solve one GEMM against the precomputed tile inverse."""

    def rec(oo, ss):
        if ss <= nb:
            inv = invd[(o + oo) // nb]
            b[:, oo:oo + ss] = mm(b[:, oo:oo + ss], ct(inv))
            return
        s1 = _split(ss, nb)
        rec(oo, s1)
        off = a[o + oo + s1:o + oo + ss, o + oo:o + oo + s1]
        b[:, oo + s1:oo + ss].addmm_(b[:, oo:oo + s1], ct(off), alpha=-1)
        rec(oo + s1, ss - s1)

    rec(0, s)
    return b


def potrf_upper(a: torch.Tensor, nb: int, clean: bool = True) -> torch.Tensor:
    """Upper Cholesky (A = U^H U) of SPD ``a``, in place; the mirror of
    :func:`potrf_lower`. The panel solve is a left solve
    (U12 = U11^-H A12) and the trailing update is herk(trans='C'), which
    runs through the fused kernel K2 under
    ``potrf_trailing_kernel="kernel"``.
    """
    n = _check_tiled(a, nb)
    invd = a.new_zeros((n // nb, min(nb, n), min(nb, n)))

    def rec(o, s):
        if s <= nb:
            f = potrf_leaf(a[o:o + s, o:o + s], upper=True)
            a[o:o + s, o:o + s] = f
            invd[o // nb] = tri_inv(f, lower=False, nb=64)
            return
        s1 = _split(s, nb)
        rec(o, s1)
        # A12 <- U11^-H A12
        u12 = _trsm_left_uc_preinv(a[o:o + s1, o + s1:o + s], a, invd, o, s1, nb)
        # A22 <- A22 - U12^H U12
        _herk_inplace(a, o + s1, s - s1, u12, lower=False, trans="C",
                      alpha=-1.0, beta=1.0, nb=nb)
        rec(o + s1, s - s1)

    rec(0, n)
    return a.triu_() if clean else a


def _trsm_left_uc_preinv(b, a, invd, o, s, nb):
    """U^H X = B in place, U = a[o:o+s, o:o+s] (upper, factored), each
    diagonal solve one GEMM against the precomputed tile inverse."""

    def rec(oo, ss):
        if ss <= nb:
            inv = invd[(o + oo) // nb]
            b[oo:oo + ss] = mm(ct(inv), b[oo:oo + ss])
            return
        s1 = _split(ss, nb)
        rec(oo, s1)
        off = a[o + oo:o + oo + s1, o + oo + s1:o + oo + ss]
        b[oo + s1:oo + ss].addmm_(ct(off), b[oo:oo + s1], alpha=-1)
        rec(oo + s1, ss - s1)

    rec(0, s)
    return b


def _herk_inplace(c, o, s, a, *, lower, trans, alpha, beta, nb):
    """Triangle-only rank-k update of the diagonal block C[o:o+s, o:o+s],
    in place; ``a``'s n-dimension index 0 aligns with row/col ``o`` of that
    block."""
    ta = Trans.NoTrans if trans == "N" else Trans.ConjTrans
    tb = Trans.ConjTrans if trans == "N" else Trans.NoTrans

    def blk(lo, ln):
        return a[lo:lo + ln] if trans == "N" else a[:, lo:lo + ln]

    def rec(co, s):
        if s <= nb:
            g = mm(blk(co - o, s), blk(co - o, s), ta=ta, tb=tb)
            cb = c[co:co + s, co:co + s]
            cb.copy_(set_tri(cb, beta * cb + alpha * g, lower))
            return
        s1 = _split(s, nb)
        rec(co, s1)
        rec(co + s1, s - s1)
        if lower:
            c[co + s1:co + s, co:co + s1].addmm_(
                op_mat(blk(co - o + s1, s - s1), ta), op_mat(blk(co - o, s1), tb),
                beta=beta, alpha=alpha)
            return
        x = blk(co - o, s1)
        y = blk(co - o + s1, s - s1)
        cb = c[co:co + s1, co + s1:co + s]
        if trans == "C" and alpha == -1.0 and beta == 1.0 and \
                get_tune_parameters().potrf_trailing_kernel == "kernel" and \
                ksub_available(cb, x, y):
            # upper-POTRF hot path: product and subtract in one kernel (K2)
            ksub_matmul(cb, x, y)
            return
        cb.addmm_(op_mat(x, ta), op_mat(y, tb), beta=beta, alpha=alpha)

    rec(o, s)
