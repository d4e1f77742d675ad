"""Max-norm of local and distributed matrices.

PyTorch counterpart of :mod:`dlaf_tpu.algos.norm` (reference
``dlaf::auxiliary::max_norm``, ``auxiliary/norm.h:26-50``,
``norm/mc.h:34-150``): locally one masked max; distributed, each rank's
masked max over the entries of its shard inside the matrix (and the
referenced triangle), then a max over the grid.
"""
from __future__ import annotations

import torch

from ..comm import collectives as coll
from ..matrix.dist_matrix import DistMatrix, global_indices

# rows of the blocks the distributed norm works through (its masks stay
# below 4096 x ln)
_ROWS = 4096


def max_norm_local(a: torch.Tensor, uplo: str = "G") -> torch.Tensor:
    """max |a_ij| as a 0-dim real tensor: uplo='G' the full matrix, 'L'/'U'
    the referenced triangle only (diagonal included); 0 for an empty
    matrix."""
    if a.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=a.device)
    if uplo == "G":
        v = a
    elif uplo == "L":
        v = torch.tril(a)
    elif uplo == "U":
        v = torch.triu(a)
    else:
        raise ValueError(f"uplo must be 'G', 'L' or 'U', got {uplo!r}")
    return v.abs().max()


def max_norm(a: DistMatrix, uplo: str = "G") -> torch.Tensor:
    """Distributed max-norm as a 0-dim real tensor on the shard's device,
    the same on every rank (every rank of the grid calls it): the entries
    inside the global (m, n) matrix, and for 'L'/'U' inside the referenced
    triangle (diagonal included)."""
    if uplo not in ("G", "L", "U"):
        raise ValueError(f"uplo must be 'G', 'L' or 'U', got {uplo!r}")
    nb = a.block_size
    m, n = a.dist.size
    P, Q = a.grid.grid_size
    p, q = a.grid.coords
    x = a.data
    lm, ln = x.shape
    grow = global_indices(lm // nb, nb, P, p, x.device)
    gcol = global_indices(ln // nb, nb, Q, q, x.device)
    cols = gcol < n
    best = torch.zeros((), dtype=x.real.dtype, device=x.device)
    for r0 in range(0, lm, _ROWS):
        r1 = min(r0 + _ROWS, lm)
        g = grow[r0:r1, None]
        mask = (g < m) & cols[None, :]
        if uplo == "L":
            mask &= g >= gcol[None, :]
        elif uplo == "U":
            mask &= g <= gcol[None, :]
        best = torch.maximum(best, torch.where(mask, x[r0:r1].abs(), 0).max())
    return coll.allreduce_max(best, None, a.grid)
