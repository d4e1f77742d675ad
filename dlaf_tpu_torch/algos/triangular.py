"""Distributed triangular solve (TRSM).

Counterpart of :mod:`dlaf_tpu.algos.triangular` (reference
``solver/triangular/impl.h:476-1195``): a loop over the tile rows of B. Per
step the diagonal tile is broadcast to the grid, the owning grid row solves
its B row slab (``ops/blocked.py`` ``trsm``), the solved slab is broadcast
down the row axis, and the rows of B still to solve get one rank-nb update
from the panel of op(A). Left cases run natively; right cases reduce to
left ones on the transposed problem (two ``DistMatrix.transpose``).

JAX runs the steps as ``lax.scan`` over shrinking window buckets
(``window_buckets``), which exist to bound ``jit``'s compile time. Here the
loop runs eagerly, one step after another, and each update touches
exactly the local rows it must: local tiles are in global order, so the
rows still to solve are one contiguous range of the shard (no mask), and
padding tiles beyond the last global tile are never written.
"""
from __future__ import annotations

import torch

from ..comm import collectives as coll
from ..comm import panel
from ..comm.mesh import COL_AXIS, ROW_AXIS, Grid
from ..matrix.dist_matrix import DistMatrix
from ..ops import blocked
from ..tune import get_tune_parameters


def _first_local_tile(gt: int, n_ax: int, r: int) -> int:
    """The first local tile of the rank at coordinate ``r`` (axis of
    ``n_ax`` ranks) whose global tile is >= ``gt``."""
    return max(0, -(-(gt - r) // n_ax))


def _op_panel(a, kt: int, t0: int, t1: int, *, nb: int, trans: str, grid: Grid):
    """op(A)(i, kt) for this rank's local row tiles [t0, t1) as a (rows, nb)
    panel. Every rank of the grid row (which share t0, t1) calls it. For N
    it is A's column kt, broadcast from its grid column; for
    T and C it is A's row kt, broadcast from its grid row, gathered over
    the grid row and re-indexed by global tile (the transposed-Panel
    pattern), each tile transposed (and conjugated)."""
    P, Q = grid.grid_size
    p = grid.coords[0]
    if trans == "N":
        lc = (kt // Q) * nb
        return coll.bcast(a[t0 * nb:t1 * nb, lc:lc + nb], kt % Q, COL_AXIS, grid)
    row = panel.bcast_row_slab(a, (kt // P) * nb, kt % P, nb, grid)
    ids = torch.arange(t0, t1, device=a.device) * P + p
    tiles = panel.take_tiles(panel.all_tiles(row, COL_AXIS, nb, grid), ids)
    if trans == "C" and tiles.is_complex():
        tiles = tiles.conj()
    return tiles.transpose(1, 2).reshape(-1, nb)


def _dist_trsm_left(a, b, *, grid: Grid, nb: int, nrt: int, leaf_nb: int, lower: bool,
                    trans: str, unit: bool):
    """The step loop on this rank's shards, in place on ``b``."""
    P, Q = grid.grid_size
    p, q = grid.coords
    forward = lower == (trans == "N")
    tend = _first_local_tile(nrt, P, p)        # local row tiles holding global tiles < nrt
    for kt in (range(nrt) if forward else range(nrt - 1, -1, -1)):
        owner_p, owner_q = kt % P, kt % Q
        lk_r, lk_c = kt // P, kt // Q
        # the diagonal tile, from its owner to the grid
        mine = p == owner_p and q == owner_q
        akk = a[lk_r * nb:(lk_r + 1) * nb, lk_c * nb:(lk_c + 1) * nb] if mine else \
            a.new_empty((nb, nb))
        akk = coll.bcast2d(akk, (owner_p, owner_q), grid)
        # solve the owning grid row's B row slab, broadcast it down the column
        if p == owner_p:
            xrow = blocked.trsm(b[lk_r * nb:(lk_r + 1) * nb], akk, side="L", lower=lower,
                                trans=trans, unit=unit, nb=leaf_nb)
        else:
            xrow = b.new_empty((nb, b.shape[1]))
        xrow = coll.bcast(xrow, owner_p, ROW_AXIS, grid)
        # update the rows still to solve: global tiles > kt (forward), < kt
        t0, t1 = (_first_local_tile(kt + 1, P, p), tend) if forward else \
            (0, _first_local_tile(kt, P, p))
        if t0 >= t1:
            # nothing left here; this rank still takes part in the panel's
            # broadcast (an empty one for N), so that every rank issues the
            # same collectives in the same order
            _op_panel(a, kt, t0, t0, nb=nb, trans=trans, grid=grid)
            continue
        pan = _op_panel(a, kt, t0, t1, nb=nb, trans=trans, grid=grid)
        b[t0 * nb:t1 * nb].addmm_(pan, xrow, alpha=-1)
    return b


def triangular_solver(a: DistMatrix, b: DistMatrix, *, side: str = "L", uplo: str = "L",
                      trans: str = "N", diag: str = "N", alpha=1.0) -> DistMatrix:
    """Distributed op(A) X = alpha B (side L) or X op(A) = alpha B (side R),
    all 8 cases of the reference's distributed triangular solver
    (``solver/triangular/impl.h:476-1195``), as a new DistMatrix. A is
    triangular (its ``uplo`` triangle is read; with ``diag='U'`` not its
    diagonal) and padded with identity (``from_global(...,
    pad_identity=True)``). Every rank of the grid calls it. Right cases
    reduce to left ones by a transpose on each side of the solve
    (X op(A) = B  <=>  op(A)^T X^T = B^T; trans C takes conj(alpha)).
    """
    if side == "R":
        if trans == "C":
            y = triangular_solver(a, b.transpose(conj=True), side="L", uplo=uplo, trans="N",
                                  diag=diag, alpha=alpha.conjugate())
            return y.transpose(conj=True)
        tt = {"N": "T", "T": "N"}[trans]
        y = triangular_solver(a, b.transpose(conj=False), side="L", uplo=uplo, trans=tt,
                              diag=diag, alpha=alpha)
        return y.transpose(conj=False)
    if side != "L":
        raise ValueError(f"side must be 'L' or 'R', got {side!r}")
    if uplo not in ("L", "U") or trans not in ("N", "T", "C") or diag not in ("N", "U"):
        raise ValueError(f"bad uplo/trans/diag {uplo!r}/{trans!r}/{diag!r}")
    if not a.dist.size[0] == a.dist.size[1] == b.dist.size[0]:
        raise ValueError(f"triangular_solver: A {a.dist.size} and B {b.dist.size}")
    if a.block_size != b.block_size or a.grid.grid_size != b.grid.grid_size:
        raise ValueError("triangular_solver: A and B need the same block size and grid")
    nb = a.block_size
    leaf = min(get_tune_parameters().leaf_block_size, nb)
    x = b.data.clone(memory_format=torch.contiguous_format)
    if alpha != 1:
        x.mul_(alpha)
    _dist_trsm_left(a.data, x, grid=a.grid, nb=nb, nrt=a.dist.nr_tiles[0], leaf_nb=leaf,
                    lower=(uplo == "L"), trans=trans, unit=(diag == "U"))
    return DistMatrix(x, b.dist, b.grid)
