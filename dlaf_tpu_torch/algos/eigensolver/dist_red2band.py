"""Distributed reduction to band over a process grid.

PyTorch counterpart of :mod:`dlaf_tpu.algos.eigensolver.dist_red2band`
(reference ``eigensolver/reduction_to_band/impl.h:1112-1463``): the panel /
trailing split of the local stage 1, on block-cyclic shards, with

  - the panel gathered replicated to every rank (an (n, band) strip): each
    rank runs the same panel QR, so no reflector is broadcast;
  - the two-sided trailing update in place on the shards: W = S V T is one
    local GEMM a rank plus one allreduce over the grid, and the rank-2b
    update A -= V X^H + X V^H is local to every shard.

The band may be smaller than the distribution block (reference band < nb
by retiling): panels are ``band``-wide column slabs inside nb tiles.

JAX runs the panels as ``fori_loop``s over a few shrinking windows
(``band_window_buckets``) only to bound its compile time. Here the loop is
eager and each step touches exactly its trailing rows and columns: local
tiles are in global order, so the rows (columns) at or past the panel's
end are one contiguous suffix of the shard. The trailing matrix is kept
hermitian in both triangles (symmetrized once on entry), so W = S (V T)
needs no triangle masks and the rank-2b update is one GEMM; only the
packed lower triangle is the result (the upper one holds the trailing
updates, where JAX's holds the input).
"""
from __future__ import annotations

import bisect

import torch

from ...comm import collectives as coll
from ...comm import panel
from ...matrix.dist_matrix import DistMatrix, global_indices
from ...ops.core import ct, mm
from ...ops.householder import panel_qr, t_factor


def trailing_window(r0: int, nb: int, n_ax: int) -> int:
    """The first local tile from which every rank of an axis of ``n_ax``
    ranks holds all its rows (columns) at or past global index ``r0``:
    the window a replicated panel is gathered over (JAX ``offr``)."""
    kt0 = r0 // nb
    return max(0, -(-(kt0 - n_ax + 1) // n_ax))


def replicated_panel(a, j0: int, r0: int, width: int, nb: int, grid) -> torch.Tensor:
    """Rows [r0, pm) of the global column panel [j0, j0 + width) of the
    shard ``a``, replicated on every rank (every rank calls it): one
    broadcast along the grid row, one all_gather down the grid column,
    over the local tiles from :func:`trailing_window` on."""
    P = grid.grid_size[0]
    offr = trailing_window(r0, nb, P)
    pan = panel.gather_col_panel(a[offr * nb:], j0, width, nb, a.shape[0] // nb - offr, grid)
    return pan[r0 - offr * P * nb:]


def _red2band_step(a, taus, k: int, *, band: int, nb: int, grid, grow, gcol, grow_d, gcol_d,
                   pm: int, lc_end: int) -> None:
    """Panel k, in place on the hermitian shard ``a`` and on ``taus``."""
    Q = grid.grid_size[1]
    j0 = k * band
    r0 = j0 + band
    lr0 = bisect.bisect_left(grow, r0)          # first local row at or past r0
    lc0 = bisect.bisect_left(gcol, r0)

    # ---- replicated panel QR ----------------------------------------------
    v, taus_p, r_fac = panel_qr(replicated_panel(a, j0, r0, band, nb, grid))
    t = t_factor(v, taus_p)
    u = mm(v, t)                                 # (pm - r0, band)

    # ---- distributed W = S U over the trailing rows and columns -----------
    rows = grow_d[lr0:] - r0
    cols = gcol_d[lc0:lc_end] - r0
    sub = a[lr0:, lc0:lc_end]
    w_loc = mm(sub, u.index_select(0, cols))
    if grid.size == 1:
        w = w_loc
    else:
        w = coll.allreduce_sum(w_loc.new_zeros((pm - r0, band)).index_copy_(0, rows, w_loc),
                               None, grid)

    # ---- X = W - 1/2 V (T^H (V^H W)), replicated ----------------------------
    x = w - 0.5 * mm(v, mm(ct(t), mm(ct(v), w)))

    # ---- local rank-2b update of the trailing shard -------------------------
    left = torch.cat([v.index_select(0, rows), x.index_select(0, rows)], dim=1)
    right = torch.cat([x.index_select(0, cols), v.index_select(0, cols)], dim=1)
    sub.addmm_(left, ct(right), alpha=-1)

    # ---- write back the panel: R on the band block, V strictly below ------
    kt = j0 // nb
    if grid.coords[1] == kt % Q:
        lc = (kt // Q) * nb + j0 % nb
        newpanel = torch.tril(v, -1)
        newpanel[:band] += r_fac
        a[lr0:, lc:lc + band] = newpanel.index_select(0, rows)
    taus[j0:r0] = taus_p


def reduction_to_band_dist(a: DistMatrix, band: int | None = None):
    """Distributed reduction to band (band | block size, band <= nb) of
    the hermitian matrix whose lower triangle ``a`` holds; every rank of
    the grid calls it, and ``a`` is not written.

    Returns (packed DistMatrix, taus (n_padded,) replicated): the band and
    the reflectors in the packed lower triangle, as
    :func:`.red2band.reduction_to_band` returns them locally.
    """
    nb = a.block_size
    band = band or nb
    if nb % band:
        raise ValueError(f"reduction_to_band_dist needs band | nb, got nb={nb}, band={band}")
    m, n = a.dist.size
    if m != n:
        raise ValueError(f"reduction_to_band_dist needs a square matrix, got {a.dist.size}")
    grid = a.grid
    P, Q = grid.grid_size
    p, q = grid.coords
    pm = a.dist.padded_size[0]
    npanels = max(pm // band - 1, 0)
    work = a.symmetrize(lower=True).data
    lm, ln = work.shape
    grow_d = global_indices(lm // nb, nb, P, p, work.device)
    gcol_d = global_indices(ln // nb, nb, Q, q, work.device)
    grow, gcol = grow_d.tolist(), gcol_d.tolist()
    lc_end = bisect.bisect_left(gcol, pm)       # columns past pm pad a non-square lattice
    taus = work.new_zeros((pm,))
    for k in range(npanels):
        _red2band_step(work, taus, k, band=band, nb=nb, grid=grid, grow=grow, gcol=gcol,
                       grow_d=grow_d, gcol_d=gcol_d, pm=pm, lc_end=lc_end)
    return DistMatrix(work, a.dist, grid), taus
