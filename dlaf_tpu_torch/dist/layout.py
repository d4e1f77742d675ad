"""Global dense <-> canonical block-cyclic shard layout conversions.

Counterpart of :mod:`dlaf_tpu.dist.layout`, for torch tensors and numpy
arrays alike (numpy's ``transpose(perm)`` is torch's ``permute``). One
canonical layout, converted with reshapes and one permutation:

    canonical shards: shape (P, Q, lm, ln)
      shard [p, q] is rank (p, q)'s packed local matrix: local tile (i, j)
      lives at [p, q, i*mb:(i+1)*mb, j*nb:(j+1)*nb] and corresponds to global
      tile (i*P + p, j*Q + q)   (block-cyclic, src rank (0, 0)).

The global array must be padded to ``Distribution.padded_size`` first.
"""
from __future__ import annotations

import torch

from .distribution import Distribution


def _permute(a, perm):
    return a.permute(perm) if isinstance(a, torch.Tensor) else a.transpose(perm)


def scatter_to_shards(a, dist: Distribution):
    """(pm, pn) padded global array -> (P, Q, lm, ln) canonical shards."""
    P, Q = dist.grid_size
    mb, nb = dist.block_size
    lmt, lnt = dist.max_local_nr_tiles
    pm, pn = dist.padded_size
    if tuple(a.shape[-2:]) != (pm, pn):
        raise ValueError(f"scatter_to_shards: shape {tuple(a.shape)}, want (..., {pm}, {pn})")
    lead = tuple(a.shape[:-2])
    a = a.reshape(lead + (lmt, P, mb, lnt, Q, nb))
    nl = len(lead)
    perm = tuple(range(nl)) + tuple(nl + k for k in (1, 4, 0, 2, 3, 5))
    return _permute(a, perm).reshape(lead + (P, Q, lmt * mb, lnt * nb))


def gather_from_shards(shards, dist: Distribution):
    """(P, Q, lm, ln) canonical shards -> (pm, pn) padded global array."""
    P, Q = dist.grid_size
    mb, nb = dist.block_size
    lmt, lnt = dist.max_local_nr_tiles
    lead = tuple(shards.shape[:-4])
    if tuple(shards.shape[-4:]) != (P, Q, lmt * mb, lnt * nb):
        raise ValueError(f"gather_from_shards: shape {tuple(shards.shape)}, "
                         f"want (..., {P}, {Q}, {lmt * mb}, {lnt * nb})")
    a = shards.reshape(lead + (P, Q, lmt, mb, lnt, nb))
    nl = len(lead)
    perm = tuple(range(nl)) + tuple(nl + k for k in (2, 0, 3, 4, 1, 5))
    return _permute(a, perm).reshape(lead + tuple(dist.padded_size))


def local_shard(a, dist: Distribution, rank) -> torch.Tensor:
    """Rank (p, q)'s shard of the padded global tensor ``a``: the same as
    ``scatter_to_shards(a, dist)[p, q]``, but only that shard is copied,
    into a new contiguous tensor on ``a``'s device."""
    P, Q = dist.grid_size
    mb, nb = dist.block_size
    lmt, lnt = dist.max_local_nr_tiles
    pm, pn = dist.padded_size
    if tuple(a.shape) != (pm, pn):
        raise ValueError(f"local_shard: shape {tuple(a.shape)}, want ({pm}, {pn})")
    p, q = rank
    view = a.reshape(lmt, P, mb, lnt, Q, nb)[:, p, :, :, q, :]
    out = a.new_empty((lmt, mb, lnt, nb))
    out.copy_(view)
    return out.view(lmt * mb, lnt * nb)
