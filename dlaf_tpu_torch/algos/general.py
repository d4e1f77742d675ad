"""Distributed general, hermitian and triangular matrix multiplication.

Counterpart of :mod:`dlaf_tpu.algos.general` (reference
``multiplication/general/impl.h:35-151``,
``multiplication/hermitian/impl.h:68-212`` and the multiply side of
``multiplication/triangular``): a SUMMA loop over the k panels. Per panel,
A's column panel is broadcast along the grid row and B's row panel down
the grid column, and every rank adds one local rank-nb product into its
shard of C.

A triangle-stored operand never becomes a full matrix: its k panel is
assembled per step from the stored column (the stored triangle's side of
the diagonal) and, for the hermitian modes only, the conjugate-transposed
stored row (the other side), with the diagonal tile made hermitian or
triangular. Local tiles are in global order, so each side is one
contiguous range of the shard's rows, and a triangular operand's product
touches only the rows on its stored side (about half the flops of the
masked full-height product JAX runs).
"""
from __future__ import annotations

import torch

from ..comm import panel
from ..comm.mesh import Grid
from ..dist import Distribution
from ..matrix.dist_matrix import DistMatrix
from ..ops.core import symmetrize_tri, take_tri
from .triangular import _first_local_tile, _op_panel


def _row_panel(b, kt: int, nb: int, grid: Grid):
    """B(kt, j) for this rank's local column tiles -> (nb, ln), broadcast
    from the owning grid row."""
    return panel.bcast_row_slab(b, (kt // grid.grid_size[0]) * nb, kt % grid.grid_size[0], nb,
                                grid)


def _a_panel(a, kt: int, nb: int, grid: Grid, a_mode: str):
    """The k panel of A for this rank's rows: (panel, t0), the panel's
    rows being the local row tiles from t0 on, or None where this grid row
    has none. ``a_mode``: 'full' plain A; 'herm_L'/'herm_U' A hermitian
    with that triangle stored; 'tril'/'triu' (+ '_unit') A triangular,
    whose panel holds only the rows on the stored side of the diagonal
    (JAX masks the others to zero and multiplies them too)."""
    lmt = a.shape[0] // nb
    if a_mode == "full":
        return _op_panel(a, kt, 0, lmt, nb=nb, trans="N", grid=grid), 0
    P = grid.grid_size[0]
    p = grid.coords[0]
    lower = a_mode in ("herm_L", "tril", "tril_unit")
    # local row tiles [0, td) hold global tiles < kt, [td, tg) the diagonal
    # tile kt if this grid row owns it, [tg, lmt) the tiles > kt
    td = _first_local_tile(kt, P, p)
    tg = _first_local_tile(kt + 1, P, p)
    if a_mode.startswith("tri"):
        t0, t1 = (td, lmt) if lower else (0, tg)
        if t0 >= t1:
            # none here; take part in the (empty) broadcast all the same, so
            # that every rank issues the same collectives in the same order
            _op_panel(a, kt, t0, t0, nb=nb, trans="N", grid=grid)
            return None
        ap = _op_panel(a, kt, t0, t1, nb=nb, trans="N", grid=grid)
        if tg > td:
            d = slice((td - t0) * nb, (tg - t0) * nb)
            ap = ap.clone()
            ap[d] = take_tri(ap[d], lower, a_mode.endswith("unit"))
        return ap, t0
    colp = _op_panel(a, kt, 0, lmt, nb=nb, trans="N", grid=grid)
    ap = torch.zeros_like(colp)
    stored = slice(tg * nb, None) if lower else slice(0, td * nb)
    ap[stored] = colp[stored]
    # the other side of the diagonal from the conjugate-transposed row
    # (an all_gather a step: only the hermitian modes pay it)
    o0, o1 = (0, td) if lower else (tg, lmt)
    ap[o0 * nb:o1 * nb] = _op_panel(a, kt, o0, o1, nb=nb, trans="C", grid=grid)
    if tg > td:
        ap[td * nb:tg * nb] = symmetrize_tri(colp[td * nb:tg * nb], lower)
    return ap, 0


def _run(a: DistMatrix, b: DistMatrix, c, alpha, beta, a_mode: str) -> DistMatrix:
    if a.grid.grid_size != b.grid.grid_size or a.block_size != b.block_size:
        raise ValueError("A and B need the same block size and grid")
    if a.dist.size[1] != b.dist.size[0]:
        raise ValueError(f"inner sizes differ: A {a.dist.size}, B {b.dist.size}")
    nb = a.block_size
    grid = a.grid
    if c is None:
        d = Distribution((a.dist.size[0], b.dist.size[1]), (nb, nb), grid.grid_size)
        lmt, lnt = d.max_local_nr_tiles
        out = a.data.new_zeros((lmt * nb, lnt * nb))
        c = DistMatrix(out, d, grid)
    else:
        out = c.data * beta
    for kt in range(a.dist.nr_tiles[1]):
        bp = _row_panel(b.data, kt, nb, grid)
        panel_rows = _a_panel(a.data, kt, nb, grid, a_mode)
        if panel_rows is None:
            continue
        ap, t0 = panel_rows
        out[t0 * nb:t0 * nb + ap.shape[0]].addmm_(ap, bp, alpha=alpha)
    return DistMatrix(out, c.dist, grid)


def general_multiplication(a: DistMatrix, b: DistMatrix, c=None, alpha=1.0,
                           beta=0.0) -> DistMatrix:
    """C <- alpha A B + beta C as a new DistMatrix (reference
    ``multiplication/general.h:52``, the NoTrans/NoTrans distributed case);
    without ``c``, alpha A B. Every rank of the grid calls it."""
    return _run(a, b, c, alpha, beta, "full")


def hermitian_multiplication(a: DistMatrix, b: DistMatrix, c=None, *, uplo: str = "L",
                             alpha=1.0, beta=0.0) -> DistMatrix:
    """C <- alpha A B + beta C with A hermitian, its ``uplo`` triangle
    stored (reference ``dlaf::hermitian_multiplication``, left side), as a
    new DistMatrix."""
    if uplo not in ("L", "U"):
        raise ValueError(f"uplo must be 'L' or 'U', got {uplo!r}")
    return _run(a, b, c, alpha, beta, "herm_L" if uplo == "L" else "herm_U")


def triangular_multiplication(a: DistMatrix, b: DistMatrix, *, side: str = "L",
                              uplo: str = "L", diag: str = "N", alpha=1.0) -> DistMatrix:
    """alpha A B (side L) or alpha B A (side R) with A triangular (its
    ``uplo`` triangle read; with ``diag='U'`` a unit diagonal), as a new
    DistMatrix. The reference distributes the four NoTrans cases
    (``multiplication/triangular/api.h:17-75``); the right side reduces to
    the left one by transposes (B A = (A^T B^T)^T, the triangle flips)."""
    if uplo not in ("L", "U") or diag not in ("N", "U"):
        raise ValueError(f"bad uplo/diag {uplo!r}/{diag!r}")
    if side == "R":
        y = triangular_multiplication(a.transpose(conj=False), b.transpose(conj=False),
                                      side="L", uplo=("U" if uplo == "L" else "L"), diag=diag,
                                      alpha=alpha)
        return y.transpose(conj=False)
    if side != "L":
        raise ValueError(f"side must be 'L' or 'R', got {side!r}")
    mode = ("tril" if uplo == "L" else "triu") + ("_unit" if diag == "U" else "")
    return _run(a, b, None, alpha, 0.0, mode)
