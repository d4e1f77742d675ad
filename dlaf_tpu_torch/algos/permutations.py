"""Row/column permutations of local and distributed matrices.

PyTorch counterpart of :mod:`dlaf_tpu.algos.permutations` (reference
``dlaf::permutations::permute``, ``permutations/general/impl.h:135``
local, ``:616`` distributed): locally one gather; distributed, the grid
column's (row's) shards are gathered along the permuted axis, and each
rank gathers its own block-cyclic rows (columns) out of them. A row
permutation exchanges data only within a grid column, and vice versa.
"""
from __future__ import annotations

import torch

from ..comm import collectives as coll
from ..comm.mesh import COL_AXIS, ROW_AXIS
from ..matrix.dist_matrix import DistMatrix, global_indices


def permute_local(a: torch.Tensor, perm, axis: int = 0) -> torch.Tensor:
    """out[i] = a[perm[i]] along ``axis`` (reference Coord::Row/Col), as a
    new tensor."""
    perm = torch.as_tensor(perm, dtype=torch.long, device=a.device)
    return torch.index_select(a, axis, perm)


def permute(a: DistMatrix, perm, axis: int = 0) -> DistMatrix:
    """Distributed permutation as a new DistMatrix: global row (column) i
    of the result is row (column) ``perm[i]`` of ``a``; padding rows
    (columns) are zero. Every rank of the grid calls it with the same
    ``perm``. Transient memory: the grid column's (row's) shards, O(n l)."""
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    nb = a.block_size
    n = a.dist.size[axis]
    grid = a.grid
    x = a.data
    ax = ROW_AXIS if axis == 0 else COL_AXIS
    n_ax = grid.axis_size(ax)
    lt = x.shape[axis] // nb
    perm = torch.as_tensor(perm, dtype=torch.long, device=x.device)
    # the axis's shards in global order along the permuted dimension
    allx = coll.allgather_tiles(x, ax, grid)                  # (n_ax, lm, ln)
    if axis == 0:
        glob = allx.reshape(n_ax, lt, nb, -1).transpose(0, 1).reshape(n_ax * lt * nb, -1)
    else:
        glob = allx.reshape(n_ax, x.shape[0], lt, nb).permute(1, 2, 0, 3) \
            .reshape(x.shape[0], n_ax * lt * nb)
    del allx
    mine = global_indices(lt, nb, n_ax, grid.axis_index(ax), x.device)
    inside = mine < n
    src = torch.where(inside, perm[mine.clamp(max=n - 1)], 0)
    out = glob.index_select(axis, src)
    out.index_fill_(axis, torch.nonzero(~inside).squeeze(1), 0)
    return DistMatrix(out, a.dist, grid)
