"""Blocked recursive BLAS-3/LAPACK building blocks (single device).

PyTorch counterpart of :mod:`dlaf_tpu.ops.blocked`: POTRF (with its two
pre-inverted panel solves), TRSM, TRMM, HERK, HER2K, HEMM and GEMM. The
recursion is the same static tile-aligned halving; what JAX writes as
functional ``.at[].set`` updates are in-place writes into the one working
buffer here: every function below modifies the tensor it is given (a view
into that buffer) and returns it. Block updates of the form
C <- beta C + alpha op(A) op(B) are one ``addmm_`` into the view, so the
plain route allocates no product.

Each recursion is a nested ``rec`` that calls itself, so it refers to
itself through its closure; it is deleted after the top-level call, so
that the buffers it closes over are freed with their last reference and
not at the next garbage collection (on the card, full-size buffers would
otherwise outlive the call).

The triangular recursions (POTRF, TRSM, TRMM) require dimensions to be
multiples of the leaf size ``nb`` (the public API pads, see
:mod:`dlaf_tpu_torch.api.local`); HERK and HER2K take any n. All are
dtype generic and follow BLAS semantics for which triangle is read and
written.
"""
from __future__ import annotations

import torch

from ..tune import get_tune_parameters
from ..types import Trans
from .core import ct, mm, op_mat, set_tri, symmetrize_tri, take_tri
from .householder import tri_inv
from .kernels.trailing import ksub_available, ksub_matmul
from .leaf import potrf_leaf, trsm_leaf


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
    del rec
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
    del rec
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
    del rec
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
    del rec
    return b


# ---------------------------------------------------------------------------
# TRSM — triangular solve with multiple right-hand sides


def trsm(b, a, *, side: str, lower: bool, trans: str, unit: bool, nb: int, alpha=1.0):
    """Solve op(A) X = alpha B (side='L') or X op(A) = alpha B (side='R') in
    place: X overwrites ``b``. All 8 side/uplo/trans cases of the
    reference's triangular solver (``solver/triangular/impl.h:236-473``),
    the right-side ones by the native column-block recursion, as in JAX."""
    if alpha != 1:
        b.mul_(alpha)
    if side == "R":
        return _trsm_right(b, a, lower, trans, unit, nb)
    return _trsm_left(b, a, lower, trans, unit, nb)


def _trsm_left(b, a, lower, trans, unit, nb):
    n = _check_tiled(a, nb)
    if b.shape[0] != n:
        raise ValueError(f"trsm: b has {b.shape[0]} rows, A is {n} x {n}")
    forward = (lower and trans == "N") or (not lower and trans != "N")

    def rec(o, s):
        if s <= nb:
            b[o:o + s] = trsm_leaf(a[o:o + s, o:o + s], b[o:o + s], left=True,
                                   lower=lower, trans=trans, unit=unit)
            return
        s1 = _split(s, nb)
        # op(A)'s off-diagonal block: A21 or op(A12) below-left (forward),
        # A12 or op(A21) above-right (backward)
        m = op_mat(a[o + s1:o + s, o:o + s1] if lower else a[o:o + s1, o + s1:o + s], trans)
        if forward:
            rec(o, s1)
            b[o + s1:o + s].addmm_(m, b[o:o + s1], alpha=-1)
            rec(o + s1, s - s1)
            return
        rec(o + s1, s - s1)
        b[o:o + s1].addmm_(m, b[o + s1:o + s], alpha=-1)
        rec(o, s1)

    rec(0, n)
    del rec
    return b


def _trsm_right(b, a, lower, trans, unit, nb):
    """X op(A) = B by column-block recursion (all four lower/trans cases);
    the updates are ``addmm_`` into column views of ``b``."""
    n = _check_tiled(a, nb)
    if b.shape[1] != n:
        raise ValueError(f"trsm: b has {b.shape[1]} columns, A is {n} x {n}")
    forward = (lower and trans != "N") or (not lower and trans == "N")

    def rec(o, s):
        if s <= nb:
            b[:, o:o + s] = trsm_leaf(a[o:o + s, o:o + s], b[:, o:o + s], left=False,
                                      lower=lower, trans=trans, unit=unit)
            return
        s1 = _split(s, nb)
        # op(A)'s off-diagonal block: A12 or op(A21) above-right (forward),
        # A21 or op(A12) below-left (backward)
        m = op_mat(a[o + s1:o + s, o:o + s1] if lower else a[o:o + s1, o + s1:o + s], trans)
        if forward:
            rec(o, s1)
            b[:, o + s1:o + s].addmm_(b[:, o:o + s1], m, alpha=-1)
            rec(o + s1, s - s1)
            return
        rec(o + s1, s - s1)
        b[:, o:o + s1].addmm_(b[:, o + s1:o + s], m, alpha=-1)
        rec(o, s1)

    rec(0, n)
    del rec
    return b


# ---------------------------------------------------------------------------
# TRMM — triangular matrix multiply


def trmm(b, a, *, side: str, lower: bool, trans: str, unit: bool, nb: int, alpha=1.0):
    """B <- alpha op(A) B (side='L') or alpha B op(A) (side='R'), in place.

    Reference: ``multiplication/triangular`` (8 local cases,
    ``multiplication/triangular/api.h:17-75``). The right side runs the
    left recursion on the transposed view: B op(A) = (op(A)^T B^T)^T; for
    trans='C', on B^H by conjugating ``b`` in place before and after.
    """
    if alpha != 1:
        b.mul_(alpha)
    if side == "L":
        return _trmm_left(b, a, lower, trans, unit, nb)
    if trans == "C":
        # B A^H = ((A B^H)^H): b.T of conj(b) is B^H
        b.conj_physical_()
        _trmm_left(b.T, a, lower, "N", unit, nb)
        return b.conj_physical_()
    _trmm_left(b.T, a, lower, {"N": "T", "T": "N"}[trans], unit, nb)
    return b


def _trmm_left(b, a, lower, trans, unit, nb):
    n = _check_tiled(a, nb)
    if b.shape[0] != n:
        raise ValueError(f"trmm: b has {b.shape[0]} rows, A is {n} x {n}")
    low_block = (lower and trans == "N") or (not lower and trans != "N")

    def rec(o, s):
        if s <= nb:
            b[o:o + s] = mm(take_tri(a[o:o + s, o:o + s], lower, unit), b[o:o + s],
                            ta=Trans(trans))
            return
        s1 = _split(s, nb)
        m = op_mat(a[o + s1:o + s, o:o + s1] if lower else a[o:o + s1, o + s1:o + s], trans)
        # op(A)'s off-diagonal block adds m times the ORIGINAL source half
        # into the other half. Each recursion writes only its own half, so
        # the half that receives the cross term is recursed first, the
        # cross term added while the source half is still unchanged, and
        # the source half recursed last.
        if low_block:
            rec(o + s1, s - s1)
            b[o + s1:o + s].addmm_(m, b[o:o + s1])
            rec(o, s1)
            return
        rec(o, s1)
        b[o:o + s1].addmm_(m, b[o + s1:o + s])
        rec(o + s1, s - s1)

    rec(0, n)
    del rec
    return b


# ---------------------------------------------------------------------------
# HERK / HER2K — hermitian rank-k updates (only the referenced triangle written)


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
    del rec


def herk(c, a, *, lower: bool, trans: str, alpha=1.0, beta=1.0, nb: int = 128):
    """C <- alpha op(A) op(A)^H + beta C on the referenced triangle, in place.

    trans='N': op(A) = A (n x k); trans='C': op(A) = A^H (reference
    tile::herk, ``blas/tile.h:473-479``). Off-diagonal quadrants are one
    ``addmm_`` each (K2 for uplo U, trans C, alpha -1, beta 1 in f32);
    only the leaf diagonal blocks compute a wasted half-triangle.
    """
    _herk_inplace(c, 0, c.shape[0], a, lower=lower, trans=trans, alpha=alpha, beta=beta,
                  nb=nb)
    return c


def her2k(c, a, b, *, lower: bool, trans: str, alpha=1.0, beta=1.0, nb: int = 128):
    """C <- alpha op(A) op(B)^H + conj(alpha) op(B) op(A)^H + beta C on the
    referenced triangle, in place."""
    ta = Trans.NoTrans if trans == "N" else Trans.ConjTrans
    tb = Trans.ConjTrans if trans == "N" else Trans.NoTrans
    calpha = alpha.conjugate()

    def blk(x, lo, ln):
        return x[lo:lo + ln] if trans == "N" else x[:, lo:lo + ln]

    def two_into(cv, lo1, ln1, lo2, ln2, beta):
        cv.addmm_(op_mat(blk(a, lo1, ln1), ta), op_mat(blk(b, lo2, ln2), tb),
                  beta=beta, alpha=alpha)
        cv.addmm_(op_mat(blk(b, lo1, ln1), ta), op_mat(blk(a, lo2, ln2), tb), alpha=calpha)

    def rec(o, s):
        if s <= nb:
            cb = c[o:o + s, o:o + s]
            upd = cb.clone()
            two_into(upd, o, s, o, s, beta)
            cb.copy_(set_tri(cb, upd, lower))
            return
        s1 = _split(s, nb)
        rec(o, s1)
        rec(o + s1, s - s1)
        if lower:
            two_into(c[o + s1:o + s, o:o + s1], o + s1, s - s1, o, s1, beta)
        else:
            two_into(c[o:o + s1, o + s1:o + s], o, s1, o + s1, s - s1, beta)

    rec(0, c.shape[0])
    del rec
    return c


# ---------------------------------------------------------------------------
# HEMM — hermitian matrix multiply


def hemm(c, a, b, *, side: str, lower: bool, alpha=1.0, beta=0.0):
    """C <- alpha A B + beta C ('L') or alpha B A + beta C ('R'), in place;
    A hermitian with only the ``lower``/upper triangle stored (reference
    ``multiplication/hermitian/impl.h:68``). The full hermitian operand is
    materialized once, so the product is one large GEMM."""
    full = symmetrize_tri(a, lower)
    if side == "L":
        return c.addmm_(full, b, beta=beta, alpha=alpha)
    return c.addmm_(b, full, beta=beta, alpha=alpha)


# ---------------------------------------------------------------------------
# GEMM


def gemm(c, a, b, *, transa: str = "N", transb: str = "N", alpha=1.0, beta=0.0):
    """C <- alpha op(A) op(B) + beta C in place (reference
    ``multiplication/general``)."""
    return c.addmm_(op_mat(a, transa), op_mat(b, transb), beta=beta, alpha=alpha)
