"""2-D block-cyclic Distribution.

A copy of :mod:`dlaf_tpu.dist.distribution` (the port does not import the
JAX package). TPU-native analog of the reference's ``include/dlaf/matrix/distribution.h:111``
``Distribution`` class: pure index bookkeeping tying a global (m, n) matrix,
a (mb, nb) block size, and a (P, Q) process/device grid together, exposing the
same global<->local conversion surface (documented in the reference at
``matrix/distribution.h:82-108``).

Like the reference (``matrix/distribution.h:59-63``) the *block* — the cyclic
distribution unit — may span several *tiles* — the algorithmic unit
(``tile_size`` divides ``block_size``).  A finer-tiled view of the same
distribution is obtained with :meth:`retiled` (the analog of
``Matrix::retiledSubPipeline``, ``matrix/matrix.h:377-432``); the canonical
shard layout (``padded_size`` / ``max_local_nr_tiles``) is invariant under
retiling because it is defined in block units.  Algorithms in
:mod:`dlaf_tpu.algos` operate on ``block == tile`` distributions — the same
restriction the reference's algorithms impose outside the eigensolver's
retiled band handling.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from . import index as ix


@dataclasses.dataclass(frozen=True)
class Distribution:
    size: Tuple[int, int]          # global (m, n) in elements
    block_size: Tuple[int, int]    # (mb, nb) in elements: distribution unit
    grid_size: Tuple[int, int] = (1, 1)    # (P, Q) device grid
    src_rank: Tuple[int, int] = (0, 0)     # rank owning block (0, 0)
    tile_size: Optional[Tuple[int, int]] = None  # algorithmic unit; None = block

    def __post_init__(self):
        m, n = self.size
        mb, nb = self.block_size
        P, Q = self.grid_size
        if m < 0 or n < 0:
            raise ValueError(f"negative size {self.size}")
        if mb <= 0 or nb <= 0:
            raise ValueError(f"non-positive block size {self.block_size}")
        if P <= 0 or Q <= 0:
            raise ValueError(f"non-positive grid {self.grid_size}")
        if not (0 <= self.src_rank[0] < P and 0 <= self.src_rank[1] < Q):
            raise ValueError(f"src_rank {self.src_rank} outside grid {self.grid_size}")
        if self.tile_size is not None:
            tm, tn = self.tile_size
            if tm <= 0 or tn <= 0 or mb % tm or nb % tn:
                raise ValueError(
                    f"tile size {self.tile_size} must divide block {self.block_size}")

    # -- block/tile structure -------------------------------------------------
    @property
    def tile(self) -> Tuple[int, int]:
        """Effective tile size (== block size unless retiled)."""
        return self.tile_size if self.tile_size is not None else self.block_size

    @property
    def tiles_per_block(self) -> Tuple[int, int]:
        t = self.tile
        return (self.block_size[0] // t[0], self.block_size[1] // t[1])

    def retiled(self, tile_size: Tuple[int, int]) -> "Distribution":
        """Finer-tiled view of the same distribution (reference
        ``retiledSubPipeline``, ``matrix/matrix.h:377-432``): ownership and
        memory layout are unchanged, only the algorithmic tiling is."""
        ts = None if tile_size == self.block_size else tile_size
        return Distribution(self.size, self.block_size, self.grid_size,
                            self.src_rank, ts)

    # -- global shape queries -------------------------------------------------
    @property
    def nr_tiles(self) -> Tuple[int, int]:
        t = self.tile
        return (ix.ceil_div(self.size[0], t[0]),
                ix.ceil_div(self.size[1], t[1]))

    @property
    def nr_blocks(self) -> Tuple[int, int]:
        return (ix.ceil_div(self.size[0], self.block_size[0]),
                ix.ceil_div(self.size[1], self.block_size[1]))

    def tile_size_of(self, tile: Tuple[int, int]) -> Tuple[int, int]:
        t = self.tile
        return (int(ix.tile_size_of(tile[0], self.size[0], t[0])),
                int(ix.tile_size_of(tile[1], self.size[1], t[1])))

    # -- ownership ------------------------------------------------------------
    def rank_global_tile(self, tile: Tuple[int, int]) -> Tuple[int, int]:
        tpb = self.tiles_per_block
        return (ix.rank_global_tile_b(tile[0], tpb[0], self.grid_size[0],
                                      self.src_rank[0]),
                ix.rank_global_tile_b(tile[1], tpb[1], self.grid_size[1],
                                      self.src_rank[1]))

    def rank_global_element(self, el: Tuple[int, int]) -> Tuple[int, int]:
        return self.rank_global_tile(self.global_tile_index(el))

    # -- element <-> tile -----------------------------------------------------
    def global_tile_index(self, el: Tuple[int, int]) -> Tuple[int, int]:
        t = self.tile
        return (ix.tile_from_element(el[0], t[0]),
                ix.tile_from_element(el[1], t[1]))

    def tile_element_index(self, el: Tuple[int, int]) -> Tuple[int, int]:
        t = self.tile
        return (ix.tile_element_from_element(el[0], t[0]),
                ix.tile_element_from_element(el[1], t[1]))

    # -- global <-> local tiles ----------------------------------------------
    def local_tile_index(self, tile: Tuple[int, int]) -> Tuple[int, int]:
        tpb = self.tiles_per_block
        return (ix.local_tile_from_global_tile_b(tile[0], tpb[0], self.grid_size[0]),
                ix.local_tile_from_global_tile_b(tile[1], tpb[1], self.grid_size[1]))

    def global_tile_from_local(self, ltile: Tuple[int, int],
                               rank: Tuple[int, int]) -> Tuple[int, int]:
        tpb = self.tiles_per_block
        return (ix.global_tile_from_local_tile_b(ltile[0], tpb[0], self.grid_size[0],
                                                 rank[0], self.src_rank[0]),
                ix.global_tile_from_local_tile_b(ltile[1], tpb[1], self.grid_size[1],
                                                 rank[1], self.src_rank[1]))

    def next_local_tile(self, tile: Tuple[int, int],
                        rank: Tuple[int, int]) -> Tuple[int, int]:
        """First local tile on ``rank`` with global index >= ``tile`` per dim."""
        tpb = self.tiles_per_block
        return (ix.next_local_tile_from_global_tile_b(tile[0], tpb[0],
                                                      self.grid_size[0],
                                                      rank[0], self.src_rank[0]),
                ix.next_local_tile_from_global_tile_b(tile[1], tpb[1],
                                                      self.grid_size[1],
                                                      rank[1], self.src_rank[1]))

    # -- local sizes ----------------------------------------------------------
    def local_nr_tiles(self, rank: Tuple[int, int]) -> Tuple[int, int]:
        mt, nt = self.nr_tiles
        tpb = self.tiles_per_block
        return (ix.local_num_tiles_b(mt, tpb[0], self.grid_size[0], rank[0],
                                     self.src_rank[0]),
                ix.local_num_tiles_b(nt, tpb[1], self.grid_size[1], rank[1],
                                     self.src_rank[1]))

    def local_size(self, rank: Tuple[int, int]) -> Tuple[int, int]:
        out = []
        for d in range(2):
            sz, t = self.size[d], self.tile[d]
            nt = ix.ceil_div(sz, t)
            if nt == 0:
                out.append(0)
                continue
            full = int(self.local_nr_tiles(rank)[d])
            last_owner = self.rank_global_tile((nt - 1, nt - 1))[d]
            last_sz = sz - (nt - 1) * t
            out.append(full * t - (t - last_sz if last_owner == rank[d] else 0))
        return (out[0], out[1])

    # -- padded canonical layout (block units; retile-invariant) -------------
    @property
    def max_local_nr_tiles(self) -> Tuple[int, int]:
        """Blocks per rank in the padded canonical shard layout (same on all
        ranks): ceil(nr_blocks / grid) — in *block* units."""
        mt, nt = self.nr_blocks
        return (ix.ceil_div(max(mt, 1), self.grid_size[0]),
                ix.ceil_div(max(nt, 1), self.grid_size[1]))

    @property
    def padded_size(self) -> Tuple[int, int]:
        """Global size rounded up so every rank holds the same number of full
        blocks — the shape of the canonical dense layout."""
        lmt, lnt = self.max_local_nr_tiles
        return (lmt * self.grid_size[0] * self.block_size[0],
                lnt * self.grid_size[1] * self.block_size[1])

    def sub_distribution(self, offset: Tuple[int, int],
                         size: Tuple[int, int]) -> "Distribution":
        """Distribution of the sub-matrix starting at block-aligned element
        ``offset`` (reference ``matrix/distribution.h:59-63,206-213``)."""
        oi, oj = offset
        mb, nb = self.block_size
        if oi % mb or oj % nb:
            raise ValueError("sub_distribution offset must be block-aligned")
        ot = (oi // mb, oj // nb)
        src = (ix.rank_global_tile(ot[0], self.grid_size[0], self.src_rank[0]),
               ix.rank_global_tile(ot[1], self.grid_size[1], self.src_rank[1]))
        return Distribution(size, self.block_size, self.grid_size, src,
                            self.tile_size)
