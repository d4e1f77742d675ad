"""Distributed matrix in the canonical block-cyclic shard layout.

Counterpart of :class:`dlaf_tpu.matrix.dist_matrix.DistMatrix` (reference
``Matrix<T, Device>``, ``matrix/matrix.h:58``). In JAX one array of shape
(P, Q, lm, ln) holds every shard; here each rank holds its own local shard
(lm, ln) on an explicit device, with the ``Distribution`` and the
:class:`~dlaf_tpu_torch.comm.mesh.Grid`. Every rank of the grid makes the
same calls (``from_global``, ``to_global``, ``diagonal``, ``transpose``,
``symmetrize``, ``sub_matrix`` and ``set_sub_matrix`` are collective where
the grid has more than one rank; ``from_callback`` and ``retiled`` are
not).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..comm import collectives as coll
from ..comm.launch import rank_device
from ..comm.mesh import COL_AXIS, ROW_AXIS, Grid
from ..dist import Distribution, gather_from_shards, local_shard


def global_indices(lt: int, nb: int, n_ax: int, r: int, device=None) -> torch.Tensor:
    """Global element indices (int64) of the ``lt`` local tiles a rank at
    coordinate ``r`` holds along an axis of ``n_ax`` ranks."""
    tiles = torch.arange(lt, device=device) * n_ax + r
    return tiles.repeat_interleave(nb) * nb + torch.arange(nb, device=device).repeat(lt)


def _below(lt: int, nb: int, n_ax: int, r: int, limit: int) -> int:
    """How many of the local indices of :func:`global_indices` lie below
    the global index ``limit``. Global indices grow with the local index,
    so these are the first ones."""
    return sum(max(0, min(nb, limit - (t * n_ax + r) * nb)) for t in range(lt))


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


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

    @classmethod
    def from_callback(cls, cb, size, nb: int, grid: Grid, dtype, pad_identity: bool = False,
                      device=None) -> "DistMatrix":
        """This rank's shard, built without the global array:
        ``cb((row_slice, col_slice))`` returns the global region's values
        (a numpy array or tensor), and each rank calls it only for the
        tiles it holds (the multi-host construction path; the reference
        reads user-owned local memory so, ``src/c_api/utils.cpp:68``).
        Padding is zero, and ``pad_identity`` puts ones on the padded
        diagonal, as :meth:`from_global`. ``dtype`` is a torch or numpy
        dtype; ``device`` defaults to this rank's card
        (``cuda:{rank % device_count}``)."""
        m, n = size
        d = Distribution((m, n), (nb, nb), grid.grid_size)
        P, Q = grid.grid_size
        p, q = grid.coords
        lmt, lnt = d.max_local_nr_tiles
        if device is None:
            device = rank_device("cuda", grid.rank)
        out = torch.zeros((lmt * nb, lnt * nb), dtype=_torch_dtype(dtype), device=device)
        for lt in range(lmt):
            gr = (lt * P + p) * nb
            if gr >= m:
                break
            for lc in range(lnt):
                gc = (lc * Q + q) * nb
                if gc >= n:
                    break
                blk = torch.as_tensor(cb((slice(gr, min(gr + nb, m)), slice(gc, min(gc + nb, n)))))
                out[lt * nb:lt * nb + blk.shape[0], lc * nb:lc * nb + blk.shape[1]] = blk
        if pad_identity:
            _pad_diagonal_ones(out, d, grid)
        return cls(out, d, grid)

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

    def transpose(self, conj: bool = True) -> "DistMatrix":
        """Distributed (conjugate) transpose as a new DistMatrix.

        Square grid: rank (p, q) swaps its shard, transposed (and
        conjugated), with rank (q, p) in one send/receive pair; diagonal
        ranks transpose their own shard and post nothing. The new
        distribution has the sizes and block sizes swapped and the source
        rank transposed (JAX: an axis swap of the canonical layout).
        Non-square grid: one uniform tile-slot all-to-all
        (:func:`_transpose_a2a`), for src rank (0, 0) and square blocks.
        """
        P, Q = self.grid.grid_size
        m, n = self.dist.size
        if P == Q:
            newdist = Distribution((n, m), self.dist.block_size[::-1], self.grid.grid_size,
                                   self.src_rank_t())
            p, q = self.grid.coords
            if p == q:
                data = self.data.mT.contiguous()
            else:
                peer = self.grid.rank_of(q, p)
                data = coll.sendrecv(self.data.mT, peer, peer, tuple(self.data.shape[::-1]))
            if conj and data.is_complex():
                data.conj_physical_()
            return DistMatrix(data, newdist, self.grid)
        if self.dist.src_rank != (0, 0) or self.dist.block_size[0] != self.dist.block_size[1]:
            raise ValueError("transpose on a non-square grid needs src_rank (0, 0) and square "
                             f"blocks, got {self.dist.src_rank} and {self.dist.block_size}")
        newdist = Distribution((n, m), self.dist.block_size[::-1], self.grid.grid_size)
        data = _transpose_a2a(self.data, self.block_size, self.grid,
                              newdist.max_local_nr_tiles, conj)
        return DistMatrix(data, newdist, self.grid)

    def symmetrize(self, lower: bool = True) -> "DistMatrix":
        """The hermitian matrix of the stored triangle as a new DistMatrix:
        A <- tril(A) + tril(A, -1)^H for ``lower`` (triu for upper): the
        conjugate transpose (:meth:`transpose`), then a combine on global
        indices, by row blocks of the shard."""
        # the combine computes global indices for origin ownership
        if self.dist.src_rank != (0, 0):
            raise ValueError(f"symmetrize needs src_rank (0, 0), got {self.dist.src_rank}")
        t = self.transpose(conj=True)
        out = t.data
        nb = self.block_size
        P, Q = self.grid.grid_size
        p, q = self.grid.coords
        lm, ln = self.data.shape
        grow = global_indices(lm // nb, nb, P, p, out.device)
        gcol = global_indices(ln // nb, nb, Q, q, out.device)
        for r0 in range(0, lm, _COMBINE_ROWS):
            r1 = min(r0 + _COMBINE_ROWS, lm)
            g = grow[r0:r1, None]
            keep = g >= gcol[None, :] if lower else g <= gcol[None, :]
            out[r0:r1] = torch.where(keep, self.data[r0:r1], out[r0:r1])
        return DistMatrix(out, self.dist, self.grid)

    def retiled(self, tile_size) -> "DistMatrix":
        """Finer-tiled metadata view of the same shard (reference
        ``retiledSubPipeline``, ``matrix/matrix.h:377-432``): no data
        moves, only ``dist.tile`` changes."""
        return DistMatrix(self.data, self.dist.retiled(tile_size), self.grid)

    def sub_matrix(self, tile_offset, size, pad_identity: bool = False) -> "DistMatrix":
        """The tile-aligned sub-matrix of element ``size`` that starts at
        global tile ``tile_offset``, as a new canonical DistMatrix with
        src rank (0, 0) (reference ``MatrixRef``, ``matrix/matrix_ref.h:34``).

        The owner of the sub-matrix's tile (i, j) is the owner of the
        parent's tile (i + oti, j + otj): the parent's shifted by a constant
        rank offset on each axis, and the local tile index by a constant of
        the rank. So each rank slices out the block its receiver needs and
        one ``ring_shift`` per axis brings it there (JAX: one ``ppermute``
        per axis, then the slice). The sub-matrix's padding is zero, with
        ones on its padded diagonal for ``pad_identity``."""
        oti, otj = tile_offset
        m2, n2 = size
        self._check_square_origin("sub_matrix")
        nb = self.block_size
        P, Q = self.grid.grid_size
        p, q = self.grid.coords
        newdist = Distribution((m2, n2), self.dist.block_size, self.grid.grid_size)
        lmt2, lnt2 = newdist.max_local_nr_tiles
        # my block goes to rank ((p - oti) % P, (q - otj) % Q), whose first
        # sub tile is my local tile ((p - oti) % P + oti) // P
        r0 = ((p - oti) % P + oti) // P * nb
        c0 = ((q - otj) % Q + otj) // Q * nb
        lm, ln = self.data.shape
        blk = self.data.new_zeros((lmt2 * nb, lnt2 * nb))
        rows, cols = max(0, min(lm - r0, lmt2 * nb)), max(0, min(ln - c0, lnt2 * nb))
        blk[:rows, :cols] = self.data[r0:r0 + rows, c0:c0 + cols]
        blk = coll.ring_shift(blk, ROW_AXIS, self.grid, shift=-oti)
        blk = coll.ring_shift(blk, COL_AXIS, self.grid, shift=-otj)
        blk[_below(lmt2, nb, P, p, m2):] = 0
        blk[:, _below(lnt2, nb, Q, q, n2):] = 0
        if pad_identity:
            _pad_diagonal_ones(blk, newdist, self.grid)
        return DistMatrix(blk, newdist, self.grid)

    def set_sub_matrix(self, sub: "DistMatrix", tile_offset) -> "DistMatrix":
        """This matrix with ``sub``'s (m2, n2) values written at global tile
        ``tile_offset`` (the inverse of :meth:`sub_matrix`), as a new
        DistMatrix; ``sub``'s padding is not read. Each rank sends its
        shard of ``sub`` to the owner of the same tiles in the parent, one
        ``ring_shift`` per axis, and the owner copies it in."""
        oti, otj = tile_offset
        m2, n2 = sub.dist.size
        self._check_square_origin("set_sub_matrix")
        if sub.dist.block_size != self.dist.block_size or sub.dist.src_rank != (0, 0):
            raise ValueError(f"set_sub_matrix needs sub's blocks {self.dist.block_size} and "
                             f"src_rank (0, 0), got {sub.dist.block_size}, {sub.dist.src_rank}")
        nb = self.block_size
        P, Q = self.grid.grid_size
        p, q = self.grid.coords
        s = coll.ring_shift(sub.data, ROW_AXIS, self.grid, shift=oti)
        s = coll.ring_shift(s, COL_AXIS, self.grid, shift=otj)
        # the parent rows and columns that hold sub's values, and where the
        # block from rank ((p - oti) % P, (q - otj) % Q) starts among them
        lm, ln = self.data.shape
        lmt, lnt = lm // nb, ln // nb
        rlo, rhi = _below(lmt, nb, P, p, oti * nb), _below(lmt, nb, P, p, oti * nb + m2)
        clo, chi = _below(lnt, nb, Q, q, otj * nb), _below(lnt, nb, Q, q, otj * nb + n2)
        r0 = ((p - oti) % P + oti) // P * nb
        c0 = ((q - otj) % Q + otj) // Q * nb
        out = self.data.clone()
        out[rlo:rhi, clo:chi] = s[rlo - r0:rhi - r0, clo - c0:chi - c0]
        return DistMatrix(out, self.dist, self.grid)

    def _check_square_origin(self, what: str) -> None:
        if self.dist.block_size[0] != self.dist.block_size[1] or self.dist.src_rank != (0, 0):
            raise ValueError(f"{what} needs square blocks and src_rank (0, 0), got "
                             f"{self.dist.block_size}, {self.dist.src_rank}")

    def src_rank_t(self):
        return (self.dist.src_rank[1] % self.grid.grid_size[0],
                self.dist.src_rank[0] % self.grid.grid_size[1])

    @property
    def block_size(self) -> int:
        return self.dist.block_size[0]

    @property
    def local_shape(self):
        return tuple(self.data.shape)


def _pad_diagonal_ones(shard: torch.Tensor, d: Distribution, grid: Grid) -> None:
    """Ones on this rank's entries of the padded diagonal of ``d`` (global
    (g, g) for min(m, n) <= g < min of the padded sizes), in place."""
    nb = d.block_size[0]
    P, Q = grid.grid_size
    p, q = grid.coords
    g = torch.arange(min(d.size), min(d.padded_size), device=shard.device)
    t = g // nb
    own = (t % P == p) & (t % Q == q)
    g, t = g[own], t[own]
    shard[(t // P) * nb + g % nb, (t // Q) * nb + g % nb] = 1


# rows of the blocks symmetrize's combine works through (its boolean mask
# and selects stay below 4096 x ln)
_COMBINE_ROWS = 4096


def _transpose_a2a(a: torch.Tensor, nb: int, grid: Grid, new_tiles, conj: bool) -> torch.Tensor:
    """This rank's shard of A^T on a non-square (P, Q) grid, by JAX's
    tile-slot exchange (``dlaf_tpu/matrix/dist_matrix.py:246-275``).

    A's tile (i, j) lives on rank (i % P, j % Q); A^T's tile (j, i) lands
    on rank (j % P, i % Q). With g = gcd(P, Q), the tiles a source sends
    to one destination form one residue class mod lcm(P, Q) per dimension
    (CRT), so every (source, destination) pair exchanges the same number
    of tile slots: sr = ceil(lmt / (Q/g)) row tiles by sc = ceil(lnt /
    (P/g)) column tiles, padded with zeros. One ``all_to_all_single`` of
    equal slots does the exchange; the transient buffers are the local
    shard times g^2. The slot arithmetic is on host integers (this
    rank's coordinates are known), so the device work is two gathers.
    """
    P, Q = grid.grid_size
    p, q = grid.coords
    lm, ln = a.shape
    lmt, lnt = lm // nb, ln // nb
    lmt2, lnt2 = new_tiles
    g = math.gcd(P, Q)
    qg, pg = Q // g, P // g
    inv_p = pow(P // g, -1, qg) if qg > 1 else 0
    inv_q = pow(Q // g, -1, pg) if pg > 1 else 0
    sr, sc = -(-lmt // qg), -(-lnt // pg)
    dev = a.device

    def t0_of(pq_src, dst, inv, period):     # first local tile sent to dst
        return (((dst - pq_src) // g) * inv) % period

    # ---- send: slot (r, c) to rank (p2, q2) holds my tile (t0 + r*qg, u0 + c*pg)
    tiles = a.reshape(lmt, nb, lnt, nb)
    ar_r, ar_c = torch.arange(sr, device=dev), torch.arange(sc, device=dev)
    blocks = []
    for r2 in range(P * Q):
        p2, q2 = grid.coords_of(r2)
        ts = t0_of(p, q2, inv_p, qg) + ar_r * qg
        us = t0_of(q, p2, inv_q, pg) + ar_c * pg
        blk = tiles.index_select(0, ts.clamp(max=lmt - 1)).index_select(2, us.clamp(max=lnt - 1))
        valid = (ts < lmt)[:, None, None, None] & (us < lnt)[None, None, :, None]
        blocks.append(torch.where(valid, blk, 0))
    rcv = coll.all_to_all_slots(torch.stack(blocks), grid)      # (D, sr, nb, sc, nb)
    del blocks
    rtiles = rcv.permute(0, 1, 3, 2, 4).reshape(-1, nb, nb)

    # ---- my A^T tile (t2, u2) = global (i2, j2) is A's tile (j2, i2), from
    # rank (j2 % P, i2 % Q), at that source's slot for me
    idx, ok = [], []
    for t2 in range(lmt2):
        i2 = t2 * P + p
        for u2 in range(lnt2):
            j2 = u2 * Q + q
            p_s, q_s, t_s, u_s = j2 % P, i2 % Q, j2 // P, i2 // Q
            r = (t_s - t0_of(p_s, q, inv_p, qg)) // qg
            c = (u_s - t0_of(q_s, p, inv_q, pg)) // pg
            good = t_s < lmt and u_s < lnt
            ok.append(good)
            idx.append((grid.rank_of(p_s, q_s) * sr + r) * sc + c if good else 0)
    got = rtiles.index_select(0, torch.tensor(idx, device=dev))
    got = torch.where(torch.tensor(ok, device=dev)[:, None, None], got, 0)
    if conj and got.is_complex():
        got = got.conj_physical()
    # transpose each tile into the (lmt2 nb, lnt2 nb) local block
    return got.reshape(lmt2, lnt2, nb, nb).permute(0, 3, 1, 2).reshape(lmt2 * nb, lnt2 * nb)
