"""Shared panel gather/broadcast/reindex primitives.

Counterpart of :mod:`dlaf_tpu.comm.panel` (reference ``Panel`` workspace,
``matrix/panel.h:43``, and its transposed broadcast,
``communication/broadcast_panel.h:61,125``): broadcasting a column (row)
slab of the local shard from its owning grid column (row), re-indexing a
gathered slab by global tile ids (the transposed-Panel pattern), and
assembling a replicated column panel. Each takes the grid, and every rank
of the axis calls it.

Clamp-into-padding invariant (:func:`take_tiles`): requested tile ids may
fall outside the gathered range (padding tiles, or tiles below a shrinking
window's base). JAX's ``jnp.take`` returns junk rows there, which every
caller masks out right after. ``torch.index_select`` raises on such ids
instead, so :func:`take_tiles` clamps them into ``[0, ntiles - 1]``: the
same junk rows, masked the same way.
"""
from __future__ import annotations

import torch

from . import collectives as coll
from .mesh import COL_AXIS, ROW_AXIS, Grid


def bcast_col_slab(a, lc: int, owner_q: int, width: int, grid: Grid):
    """Broadcast ``a[:, lc:lc+width]`` (local column slab) from grid column
    ``owner_q`` along the row of grid ranks (reference panel broadcast,
    ``broadcast_panel.h:61``); a new tensor on every rank but the owner."""
    return coll.bcast(a[:, lc:lc + width], owner_q, COL_AXIS, grid)


def bcast_row_slab(a, lr: int, owner_p: int, width: int, grid: Grid):
    """Broadcast ``a[lr:lr+width, :]`` (local row slab) from grid row
    ``owner_p`` along the column of grid ranks."""
    return coll.bcast(a[lr:lr + width, :], owner_p, ROW_AXIS, grid)


def all_tiles(slab, axis: str, nb: int, grid: Grid):
    """all_gather a slab over ``axis`` and return it tile-major.

    ``slab`` is either a column slab (lm, w) — tiles along axis 0, gathered
    over the row axis — or a row slab (w, ln) — tiles along axis 1, gathered
    over the column axis. Returns (ntiles_global, tile_rows, tile_cols)
    where global tile g = local_tile * axis_size + axis_index (the
    block-cyclic inverse map), i.e. ``out[g]`` is the slab block of global
    tile g.
    """
    n_ax = grid.axis_size(axis)
    g = coll.allgather_tiles(slab, axis, grid)            # (n_ax, *slab.shape)
    if axis == ROW_AXIS:
        lm, w = slab.shape
        lt = lm // nb
        return g.reshape(n_ax, lt, nb, w).permute(1, 0, 2, 3).reshape(lt * n_ax, nb, w)
    w, ln = slab.shape
    lt = ln // nb
    return g.reshape(n_ax, w, lt, nb).permute(2, 0, 1, 3).reshape(lt * n_ax, w, nb)


def take_tiles(tiles, ids):
    """Select tiles by (possibly out-of-range) global tile ids, clamped
    into range; see the clamp-into-padding invariant above. A new tensor."""
    ids = torch.as_tensor(ids, device=tiles.device).clamp(0, tiles.shape[0] - 1)
    return tiles.index_select(0, ids)


def gather_col_panel(a, j0: int, width: int, nb: int, lmt: int, grid: Grid, offc: int = 0):
    """Window-local shard -> replicated (P * lmt * nb, width) global column
    panel at global column ``j0``; rows are the window's contiguous global
    range starting at tile offr*P (the caller masks). The reference's
    Panel-gather + broadcast for the stage-1 V panels
    (``reduction_to_band/impl.h:616-689``, ``matrix/panel.h:43``). ``lmt``
    is kept for the JAX signature."""
    Qn = grid.axis_size(COL_AXIS)
    kt = j0 // nb
    lc = (kt // Qn - offc) * nb + j0 % nb
    slab = bcast_col_slab(a, lc, kt % Qn, width, grid)
    return all_tiles(slab, ROW_AXIS, nb, grid).reshape(-1, width)
