"""Row/column permutation of a local matrix.

PyTorch counterpart of :func:`dlaf_tpu.algos.permutations.permute_local`
(reference ``dlaf::permutations::permute``,
``permutations/general/impl.h:135``): one gather. The distributed
``permute`` is not ported yet.
"""
from __future__ import annotations

import torch


def permute_local(a: torch.Tensor, perm, axis: int = 0) -> torch.Tensor:
    """out[i] = a[perm[i]] along ``axis`` (reference Coord::Row/Col), as a
    new tensor."""
    perm = torch.as_tensor(perm, dtype=torch.long, device=a.device)
    return torch.index_select(a, axis, perm)
