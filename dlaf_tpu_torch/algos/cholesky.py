"""Distributed tiled Cholesky factorization (POTRF).

Counterpart of :mod:`dlaf_tpu.algos.cholesky` (reference
``factorization/cholesky/impl.h:192-313``, and ``call_U`` at ``:351`` for
the upper factor). JAX runs one SPMD program over the mesh; here every rank
of the :class:`~dlaf_tpu_torch.comm.mesh.Grid` runs the same panel loop on
its own shard, in place, with its (p, q) and the grid's (P, Q) in place of
``lax.axis_index``/``axis_size``:

  - the diagonal tile is factored on its owner (K1) and broadcast to the
    grid (JAX: a masked ``psum``; here only the owner factors);
  - the panel solve runs on the owning grid column (row for U) as one GEMM
    against the tile's inverse, and the solved panel is broadcast along
    the grid row (column);
  - the transposed panel comes from an ``all_gather`` over the other axis
    and a re-index by global tile ids (``comm/panel.py``);
  - the trailing updates, inside the wide panel (rank nb) and the wide
    staircase chunks right of (below) it (rank ``wt_tiles``·nb), are masked
    to the stored triangle by global indices. On the ``"kernel"`` route
    (``potrf_trailing_kernel``) f32 updates run through K6
    (``ops/kernels/trailing.py`` ``ksub_matmul_masked``) at the three
    sites where JAX calls its Pallas kernel; other dtypes, and the
    ``"torch"`` route, take ``matmul`` + ``where`` as JAX's XLA route does.

The panel width, the U path's widening and the trailing chunks are JAX's,
so the arithmetic is the same. Not carried over: JAX's bucketed
``fori_loop`` path (``_dist_potrf_shardfn``, ``window_buckets``), which
exists only to bound XLA's compile time beyond 32 panels, and its
column-major layout variant (``preferred_format``), an XLA layout detail.
PyTorch runs eagerly, so the unrolled panel loop serves every panel count.
``donate=True`` factors the local shard in place.
"""
from __future__ import annotations

import torch

from ..comm import collectives as coll
from ..comm import panel
from ..comm.mesh import COL_AXIS, ROW_AXIS, Grid
from ..matrix.dist_matrix import DistMatrix, global_indices
from ..ops import leaf
from ..ops.core import ct
from ..ops.householder import tri_inv
from ..ops.kernels.trailing import ksub_available, ksub_matmul_masked
from ..spans import span
from ..tune import get_tune_parameters

# JAX unrolls the panel loop up to this many wide panels; its upper path
# widens the panels to stay within it, and so does this one (the same
# panels, the same arithmetic)
UNROLL_MAX_PANELS = 32
# K6's column index for panel columns that the panel-restricted update must
# not touch: above every global row index
_SENTINEL = 2**30


def _tile_step_static(pan, kt, *, grid: Grid, nb, lnt, offr, pl_c0, pl_c1, pl_end,
                      row_tile, col_tile, glob_row, glob_col, trailing_kernel):
    """One tile step of the lower panel loop, in place on the panel view
    ``pan`` (the window's rows x the panel's local columns [pl_c0, pl_c1)).

    Returns (w, wtT): the solved below-diagonal panel (window rows, nb) and
    its transposed (+ conjugated) extraction (nb, local columns from
    pl_c0), ready for the wide trailing update.
    """
    p, q = grid.coords
    Pn, Qn = grid.grid_size
    owner_p, owner_q = kt % Pn, kt % Qn
    lk_r, lk_c = kt // Pn, kt // Qn
    r0 = offr * nb
    jc = (lk_c - pl_c0) * nb           # panel-local column offset
    c0, c1 = (lk_r - offr) * nb, (lk_r - offr + 1) * nb

    # 1. factor the diagonal tile on its owner, broadcast it to the grid
    with span("cholesky.leaf"):
        tile = pan[c0:c1, jc:jc + nb]
        mine = p == owner_p and q == owner_q
        lkk = leaf.potrf_leaf(tile) if mine else pan.new_empty((nb, nb))
        lkk = coll.bcast2d(lkk, (owner_p, owner_q), grid)

    # 2. panel solve on the owning grid column: one GEMM against the
    #    tile's inverse; the factored tile's strict upper keeps its input
    with span("cholesky.solve"):
        below = (row_tile[offr:].repeat_interleave(nb) > kt)[:, None]
        if q == owner_q:
            slab = pan[:, jc:jc + nb]
            solved = slab @ ct(tri_inv(lkk, lower=True, nb=64))
            newslab = torch.where(below, solved, slab)
            if p == owner_p:
                cur = newslab[c0:c1]
                lower = torch.ones((nb, nb), dtype=torch.bool, device=pan.device).tril()
                cur.copy_(torch.where(lower, lkk, cur))
            slab.copy_(newslab)
            wl = torch.where(below, newslab, 0)
        else:
            wl = pan.new_empty((pan.shape[0], nb))

    with span("cholesky.panel_bcast"):
        # 3. broadcast the solved panel along the grid row
        w = coll.bcast(wl, owner_q, COL_AXIS, grid)

        # 4. transposed panel for the local columns from the panel start
        #    (clamp-into-padding invariant: junk tiles are masked by
        #    col_tile > kt; padding column tiles update only padding columns)
        wtT = panel.take_tiles(panel.all_tiles(w, ROW_AXIS, nb, grid),
                               col_tile[pl_c0:] - offr * Pn)
        # (contiguous: a one-tile reshape is a transposed view, which K6 refuses)
        wtT = wtT.permute(2, 0, 1).reshape(nb, (lnt - pl_c0) * nb).contiguous().conj()
        wtT = torch.where((col_tile[pl_c0:].repeat_interleave(nb) > kt)[None, :], wtT, 0)

    # 5. rank-nb update of the panel's remaining columns only: over ranks
    #    q, the first local tile holding a global tile > kt is (kt+1)//Q
    with span("cholesky.panel_update"):
        pu_c0 = max(pl_c0, (kt + 1) // Qn)
        if pu_c0 < pl_c1:
            o = (pu_c0 - pl_c0) * nb
            pw = (pl_c1 - pl_c0) * nb
            ych = wtT[:, o:pw]
            cpan = pan[:, o:]
            gcs = glob_col[pu_c0 * nb:pl_c1 * nb]
            inpanel = col_tile[pu_c0:pl_c1].repeat_interleave(nb) < pl_end
            if trailing_kernel == "kernel" and ksub_available(cpan, w, ych, x_k_major=False):
                # K6: the pl_end column bound folds into the column indices
                # as a sentinel above every row index
                gr = glob_row[r0:, None].int()
                gc = torch.where(inpanel, gcs, _SENTINEL).int()[None, :]
                ksub_matmul_masked(cpan, w, ych, gr, gc, x_k_major=False)
            else:
                mask = (glob_row[r0:, None] >= gcs[None, :]) & inpanel[None, :]
                cpan.sub_(torch.where(mask, w @ ych, 0))
    return w, wtT


def _tile_step_static_u(pan, kt, *, grid: Grid, nb, lmt, offc, pl_r0, pl_r1, pl_end,
                        row_tile, col_tile, glob_row, glob_col):
    """Upper mirror of :func:`_tile_step_static` (A = U^H U): panels are
    block rows, the panel solve is a left solve U_kj = U_kk^-H A_kj on the
    owning grid row, the solved row panel is broadcast down the grid
    column. ``pan`` is the panel's local rows [pl_r0, pl_r1) x the window's
    local columns from ``offc``. Returns (w, wt). The rank-nb update here
    is ``matmul`` + ``where`` on both routes, as in JAX."""
    p, q = grid.coords
    Pn, Qn = grid.grid_size
    owner_p, owner_q = kt % Pn, kt % Qn
    lk_r, lk_c = kt // Pn, kt // Qn
    c0g = offc * nb
    jr = (lk_r - pl_r0) * nb           # panel-local row offset
    d0, d1 = (lk_c - offc) * nb, (lk_c - offc + 1) * nb

    # 1. factor the diagonal tile on its owner, broadcast it to the grid
    with span("cholesky.leaf"):
        tile = pan[jr:jr + nb, d0:d1]
        mine = p == owner_p and q == owner_q
        ukk = leaf.potrf_leaf(tile, upper=True) if mine else pan.new_empty((nb, nb))
        ukk = coll.bcast2d(ukk, (owner_p, owner_q), grid)

    # 2. row-panel solve on the owning grid row (window columns only)
    with span("cholesky.solve"):
        right = (col_tile[offc:].repeat_interleave(nb) > kt)[None, :]
        if p == owner_p:
            slab = pan[jr:jr + nb, :]
            solved = ct(tri_inv(ukk, lower=False, nb=64)) @ slab
            newslab = torch.where(right, solved, slab)
            if q == owner_q:
                cur = newslab[:, d0:d1]
                upper = torch.ones((nb, nb), dtype=torch.bool, device=pan.device).triu()
                cur.copy_(torch.where(upper, ukk, cur))
            slab.copy_(newslab)
            wl = torch.where(right, newslab, 0)
        else:
            wl = pan.new_empty((nb, pan.shape[1]))

    with span("cholesky.panel_bcast"):
        # 3. broadcast the solved row panel down the grid column
        w = coll.bcast(wl, owner_p, ROW_AXIS, grid)

        # 4. transposed panel for the local rows from the panel start: block
        #    row i holds U(kt, i)^H (clamp-into-padding invariant as for L)
        wt = panel.take_tiles(panel.all_tiles(w, COL_AXIS, nb, grid),
                              row_tile[pl_r0:] - offc * Qn)
        wt = wt.transpose(1, 2).reshape((lmt - pl_r0) * nb, nb).contiguous().conj()
        wt = torch.where((row_tile[pl_r0:].repeat_interleave(nb) > kt)[:, None], wt, 0)

    # 5. rank-nb update of the panel's remaining rows
    with span("cholesky.panel_update"):
        pu_r0 = max(pl_r0, (kt + 1) // Pn)
        if pu_r0 < pl_r1:
            o = (pu_r0 - pl_r0) * nb
            ph = (pl_r1 - pl_r0) * nb
            mask = (glob_row[pu_r0 * nb:pl_r1 * nb, None] <= glob_col[None, c0g:]) & \
                (row_tile[pu_r0:pl_r1].repeat_interleave(nb) < pl_end)[:, None]
            pan[o:].sub_(torch.where(mask, wt[o:ph] @ w, 0))
    return w, wt


def _index_vectors(a, grid: Grid, nb):
    """Global tile and element indices of the local shard's rows and columns."""
    p, q = grid.coords
    Pn, Qn = grid.grid_size
    lmt, lnt = a.shape[0] // nb, a.shape[1] // nb
    dev = a.device
    return (torch.arange(lmt, device=dev) * Pn + p, torch.arange(lnt, device=dev) * Qn + q,
            global_indices(lmt, nb, Pn, p, dev), global_indices(lnt, nb, Qn, q, dev))


def _dist_potrf_lower(a, grid: Grid, *, nb, nrt, wt_tiles, trail_chunks, trailing_kernel):
    """The lower panel loop on this rank's shard ``a``, in place. Each wide
    panel gets exact window offsets (offr = kt0 // P, pl_c0 = kt0 // Q), so
    the staircase chunks compute no stale columns (JAX's
    ``_dist_potrf_unrolled_shardfn``)."""
    Pn, Qn = grid.grid_size
    lmt, lnt = a.shape[0] // nb, a.shape[1] // nb
    row_tile, col_tile, glob_row, glob_col = _index_vectors(a, grid, nb)

    npanels = -(-nrt // wt_tiles)
    for pk in range(npanels):
        kt0 = pk * wt_tiles
        offr = kt0 // Pn
        pl_c0 = kt0 // Qn
        pl_c1 = min(pl_c0 + wt_tiles // Qn, lnt)
        r0 = offr * nb
        pan = a[r0:, pl_c0 * nb:pl_c1 * nb]
        ws, wts = [], []
        with span("cholesky.panel", pk=pk):
            for j in range(wt_tiles):
                kt = kt0 + j
                if kt >= nrt:
                    break
                w, wtj = _tile_step_static(
                    pan, kt, grid=grid, nb=nb, lnt=lnt, offr=offr, pl_c0=pl_c0,
                    pl_c1=pl_c1, pl_end=kt0 + wt_tiles, row_tile=row_tile,
                    col_tile=col_tile, glob_row=glob_row, glob_col=glob_col,
                    trailing_kernel=trailing_kernel)
                ws.append(w)
                wts.append(wtj)
        if pl_c1 >= lnt:
            continue

        # wide staircase trailing update over local column tiles
        # [pl_c1, lnt): a k = len(ws)*nb update per chunk, its rows starting
        # at the chunk's conservative diagonal tile (reference trailing
        # herk/gemm, factorization/cholesky/impl.h:273-300)
        with span("cholesky.trailing", pk=pk):
            wide = torch.cat(ws, dim=1)
            wide_t = torch.cat(wts, dim=0)[:, (pl_c1 - pl_c0) * nb:]
            lnt_tr = lnt - pl_c1
            nch = min(trail_chunks, lnt_tr)
            cw = -(-lnt_tr // nch)
            for c0 in range(pl_c1, lnt, cw):
                c1 = min(lnt, c0 + cw)
                gmin = c0 * Qn   # min global col tile of the chunk over ranks
                t0 = min(max(offr, -(-(gmin - Pn + 1) // Pn)), lmt - 1)
                xm = wide[(t0 - offr) * nb:]
                ych = wide_t[:, (c0 - pl_c1) * nb:(c1 - pl_c1) * nb]
                ach = a[t0 * nb:, c0 * nb:c1 * nb]
                if trailing_kernel == "kernel" and ksub_available(ach, xm, ych,
                                                                  x_k_major=False):
                    gr = glob_row[t0 * nb:, None].int()
                    gc = glob_col[None, c0 * nb:c1 * nb].int()
                    ksub_matmul_masked(ach, xm, ych, gr, gc, x_k_major=False)
                    continue
                tril = glob_row[t0 * nb:, None] >= glob_col[None, c0 * nb:c1 * nb]
                ach.sub_(torch.where(tril, xm @ ych, 0))
    return a


def _dist_potrf_upper(a, grid: Grid, *, nb, nrt, wt_tiles, trail_chunks, trailing_kernel):
    """Upper mirror of :func:`_dist_potrf_lower` (JAX's
    ``_dist_potrf_unrolled_shardfn_u``), in place."""
    Pn, Qn = grid.grid_size
    lmt, lnt = a.shape[0] // nb, a.shape[1] // nb
    row_tile, col_tile, glob_row, glob_col = _index_vectors(a, grid, nb)

    npanels = -(-nrt // wt_tiles)
    for pk in range(npanels):
        kt0 = pk * wt_tiles
        offc = kt0 // Qn
        pl_r0 = kt0 // Pn
        pl_r1 = min(pl_r0 + wt_tiles // Pn, lmt)
        c0 = offc * nb
        pan = a[pl_r0 * nb:pl_r1 * nb, c0:]
        ws, wts = [], []
        with span("cholesky.panel", pk=pk):
            for j in range(wt_tiles):
                kt = kt0 + j
                if kt >= nrt:
                    break
                w, wtj = _tile_step_static_u(
                    pan, kt, grid=grid, nb=nb, lmt=lmt, offc=offc, pl_r0=pl_r0,
                    pl_r1=pl_r1, pl_end=kt0 + wt_tiles, row_tile=row_tile,
                    col_tile=col_tile, glob_row=glob_row, glob_col=glob_col)
                ws.append(w)
                wts.append(wtj)
        if pl_r1 >= lmt:
            continue

        # wide staircase trailing update over local row tiles [pl_r1, lmt):
        # row chunks, each chunk's columns starting at its conservative
        # diagonal tile
        with span("cholesky.trailing", pk=pk):
            wide = torch.cat(ws, dim=0)                         # (wt*nb, ln_w)
            wide_t = torch.cat(wts, dim=1)[(pl_r1 - pl_r0) * nb:]
            lmt_tr = lmt - pl_r1
            nch = min(trail_chunks, lmt_tr)
            rw = -(-lmt_tr // nch)
            for r0 in range(pl_r1, lmt, rw):
                r1 = min(lmt, r0 + rw)
                gmin = r0 * Pn   # min global row tile of the chunk over ranks
                t0 = min(max(offc, -(-(gmin - Qn + 1) // Qn)), lnt - 1)
                ych = wide[:, (t0 - offc) * nb:]
                xch = wide_t[(r0 - pl_r1) * nb:(r1 - pl_r1) * nb]
                ach = a[r0 * nb:r1 * nb, t0 * nb:]
                if trailing_kernel == "kernel" and ksub_available(ach, xch, ych,
                                                                  x_k_major=False):
                    # the upper mask i <= j is K6's gr >= gc on negated indices
                    gr = (-glob_row[r0 * nb:r1 * nb, None]).int()
                    gc = (-glob_col[None, t0 * nb:]).int()
                    ksub_matmul_masked(ach, xch, ych, gr, gc, x_k_major=False)
                    continue
                triu = glob_row[r0 * nb:r1 * nb, None] <= glob_col[None, t0 * nb:]
                ach.sub_(torch.where(triu, xch @ ych, 0))
    return a


def cholesky(a: DistMatrix, donate: bool = False, uplo: str = "L") -> DistMatrix:
    """Distributed Cholesky: the factor in the global ``uplo`` triangle;
    the opposite strict triangle keeps the input (reference semantics).
    Every rank of ``a.grid`` calls it. With ``donate`` the local shard is
    factored in place (and ``a`` then holds the factor); otherwise a copy.

    Wide-panel loop: each panel of ``wt_tiles`` block columns (rows for U)
    is factored with panel-restricted rank-nb updates, then the trailing
    matrix gets one rank-``wt_tiles``·nb update in staircase chunks.

    With the recorder on (:mod:`dlaf_tpu_torch.spans`) the call records a
    ``cholesky`` span, one ``cholesky.panel`` a wide panel and one
    ``cholesky.trailing`` a trailing update (each with its ``pk``), and in
    each tile step ``cholesky.leaf`` (K1 and its broadcast),
    ``cholesky.solve``, ``cholesky.panel_bcast`` (the panel's broadcast and
    transpose) and ``cholesky.panel_update`` (the in-panel update).
    """
    m, n = a.dist.size
    if m != n:
        raise ValueError(f"cholesky needs a square matrix, got {a.dist.size}")
    if uplo not in ("L", "U"):
        raise ValueError(f"uplo must be 'L' or 'U', got {uplo!r}")
    nb = a.block_size
    nrt = a.dist.nr_tiles[0]
    Pn, Qn = a.grid.grid_size
    tune = get_tune_parameters()
    # panel width, a multiple of Q tiles (contiguous local cols); for U the
    # panel is a block ROW, so the multiple is of P tiles
    ax = Pn if uplo == "U" else Qn
    wt_tiles = ax * max(1, -(-tune.potrf_dist_panel_width // (nb * ax)))
    wt_tiles = min(wt_tiles, max(ax, (nrt // ax) * ax or ax))
    npanels = -(-nrt // wt_tiles)
    unroll = npanels <= UNROLL_MAX_PANELS
    if uplo == "U" and not unroll:
        # JAX's native U path is unrolled-only: it widens panels until it fits
        wt_tiles = ax * (-(-nrt // (UNROLL_MAX_PANELS * ax)))
    tch = max(1, tune.potrf_dist_trail_chunks)
    run = _dist_potrf_upper if uplo == "U" else _dist_potrf_lower
    with span("cholesky", n=n, nb=nb, uplo=uplo, wt_tiles=wt_tiles, grid=(Pn, Qn)):
        data = a.data if donate else a.data.clone()
        run(data, a.grid, nb=nb, nrt=nrt, wt_tiles=wt_tiles, trail_chunks=tch,
            trailing_kernel=tune.potrf_trailing_kernel)
    return DistMatrix(data, a.dist, a.grid)


def cholesky_info(a: DistMatrix):
    """Distributed Cholesky (lower) plus LAPACK-style info: (L, info).

    ``info`` is a 0-dim int32 tensor on the shard's device, the same on
    every rank: 0 on success, else the 1-based index of the first
    non-positive or non-finite factor pivot (reference
    ``tile::potrfInfo``, ``lapack/tile.h:615-616``), tile-granular as the
    failure propagates through its tile. The pivots come from
    ``DistMatrix.diagonal`` (no gather of the matrix).
    """
    out = cholesky(a)
    d = out.diagonal().real
    bad = ~torch.isfinite(d) | (d <= 0)
    first = torch.argmax(bad.to(torch.int32)) + 1
    info = torch.where(bad.any(), first, torch.zeros_like(first)).to(torch.int32)
    return out, info
