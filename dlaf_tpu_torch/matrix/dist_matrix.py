"""Distributed matrix in the canonical block-cyclic shard layout.

Counterpart of :class:`dlaf_tpu.matrix.dist_matrix.DistMatrix` (reference
``Matrix<T, Device>``, ``matrix/matrix.h:58``). In JAX one array of shape
(P, Q, lm, ln) holds every shard; here each rank holds its own local shard
(lm, ln) on an explicit device, with the ``Distribution`` and the
:class:`~dlaf_tpu_torch.comm.mesh.Grid`. Every rank of the grid makes the
same calls (``from_global``, ``to_global`` and ``diagonal`` are collective
where the grid has more than one rank).

Not ported yet (ROADMAP): ``from_callback``, ``transpose``, ``symmetrize``,
``retiled``, ``sub_matrix`` and ``set_sub_matrix``, which need all-to-all
and point-to-point exchanges.
"""
from __future__ import annotations

import dataclasses

import torch

from ..comm import collectives as coll
from ..comm.mesh import Grid
from ..dist import Distribution, gather_from_shards, local_shard


def global_indices(lt: int, nb: int, n_ax: int, r: int, device=None) -> torch.Tensor:
    """Global element indices (int64) of the ``lt`` local tiles a rank at
    coordinate ``r`` holds along an axis of ``n_ax`` ranks."""
    tiles = torch.arange(lt, device=device) * n_ax + r
    return tiles.repeat_interleave(nb) * nb + torch.arange(nb, device=device).repeat(lt)


@dataclasses.dataclass
class DistMatrix:
    data: torch.Tensor         # this rank's local shard (lm, ln)
    dist: Distribution
    grid: Grid

    @classmethod
    def from_global(cls, a: torch.Tensor, nb: int, grid: Grid, pad_identity: bool = False,
                    device=None) -> "DistMatrix":
        """This rank's shard of the global (m, n) tensor ``a``, which every
        rank passes whole (the reference's replicated-input convention),
        on ``device`` (default: ``a``'s). ``pad_identity`` puts ones on the
        padded diagonal, so that triangular and SPD algorithms can run on
        the padded shape. The shard is a new tensor: ``a`` is not written."""
        m, n = a.shape
        d = Distribution((m, n), (nb, nb), grid.grid_size)
        pm, pn = d.padded_size
        a = a.to(device) if device is not None else a
        if (pm, pn) != (m, n):
            ap = a.new_zeros((pm, pn))
            ap[:m, :n] = a
            if pad_identity:
                k = min(m, n)
                ap.diagonal()[k:].fill_(1)
            a = ap
        return cls(local_shard(a, d, grid.coords), d, grid)

    def to_global(self) -> torch.Tensor:
        """The whole (m, n) matrix as a new tensor on this rank's device
        (an all_gather of the shards over the grid)."""
        m, n = self.dist.size
        if self.grid.size == 1:
            return self.data[:m, :n].clone()
        P, Q = self.grid.grid_size
        shards = coll.allgather_tiles(self.data, None, self.grid)
        order = [self.grid.rank_of(p, q) for p in range(P) for q in range(Q)]
        shards = shards[order].reshape(P, Q, *self.data.shape)
        return gather_from_shards(shards, self.dist)[:m, :n].contiguous()

    def diagonal(self) -> torch.Tensor:
        """Replicated (min(m, n),) diagonal: each rank reads the diagonal
        entries its shard holds into a zero vector, and the vectors are
        summed over the grid (no gather of the matrix; the JAX function
        masks the whole shard, which at n = 32768 would take a 4 GiB
        temporary)."""
        nb = self.dist.block_size[0]
        pm = self.dist.padded_size[0]
        P, Q = self.grid.grid_size
        p, q = self.grid.coords
        lm, ln = self.data.shape
        grow = global_indices(lm // nb, nb, P, p, self.data.device)
        tile = grow // nb
        lcol = (tile // Q) * nb + grow % nb      # local column of (grow, grow)
        rows = torch.nonzero((tile % Q == q) & (lcol < ln)).squeeze(1)
        out = self.data.new_zeros((pm,))
        out[grow[rows]] = self.data[rows, lcol[rows]]
        return coll.allreduce_sum(out, None, self.grid)[: min(self.dist.size)]

    @property
    def block_size(self) -> int:
        return self.dist.block_size[0]

    @property
    def local_shape(self):
        return tuple(self.data.shape)
