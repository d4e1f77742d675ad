"""Max-norm of a local matrix.

PyTorch counterpart of :func:`dlaf_tpu.algos.norm.max_norm_local`
(reference ``dlaf::auxiliary::max_norm``, ``auxiliary/norm.h:26-50``): one
masked max. The distributed ``max_norm`` is not ported yet.
"""
from __future__ import annotations

import torch


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
