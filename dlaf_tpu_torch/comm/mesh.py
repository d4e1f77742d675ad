"""2-D process grid over a ``torch.distributed`` process group.

Counterpart of :mod:`dlaf_tpu.comm.mesh` (reference ``CommunicatorGrid``,
``communication/communicator_grid.h:37``). In JAX a grid is a device mesh
and one SPMD program runs on all of it; here every rank is a process that
runs the algorithm on its own shard, and the grid tells it where it sits:
its coordinates (p, q) and the process subgroups of its grid column (the
``ROW_AXIS`` collectives, over p) and its grid row (the ``COL_AXIS``
collectives, over q). The subgroups are made once, when the grid is.

``Grid((1, 1))`` needs no process group: every collective over it is the
identity. A larger grid needs an initialized default process group whose
world size is P·Q. :meth:`Grid.multihost` lays the ranks of several hosts
out so that one grid axis stays inside a host.
"""
from __future__ import annotations

import socket
from typing import Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from . import collectives

ROW_AXIS = "r"  # indexes the grid row coordinate p (tiles i with i % P == p)
COL_AXIS = "c"  # indexes the grid column coordinate q


class Grid:
    """Process grid of shape (P, Q) over the default process group."""

    def __init__(self, grid_size: Optional[Tuple[int, int]] = None,
                 order: str = "R", layout: Optional[Sequence[Sequence[int]]] = None):
        """``order`` is the rank->(p, q) assignment: "R" lays rank k at
        (k // Q, k % Q), "C" at (k % P, k // P), as the JAX grid lays
        device k (reference ``dlaf_create_grid`` orderings,
        ``include/dlaf_c/grid.h:31``). ``layout``, a (P, Q) table of the
        global ranks, gives any other assignment (``order`` is then
        ignored; :meth:`multihost` makes one)."""
        if order not in ("R", "C"):
            raise ValueError(f"grid order must be 'R' or 'C', got {order!r}")
        if layout is not None:
            layout = np.asarray(layout, dtype=np.int64)
            grid_size = tuple(layout.shape) if grid_size is None else tuple(grid_size)
            if layout.shape != grid_size or sorted(layout.ravel().tolist()) != \
                    list(range(layout.size)):
                raise ValueError(f"layout must be a {grid_size} table of the ranks "
                                 f"0..{layout.size - 1} once each, got {layout.tolist()}")
        world = dist.get_world_size() if dist.is_initialized() else 1
        if grid_size is None:
            grid_size = _default_grid(world)
        P_, Q_ = grid_size
        if P_ <= 0 or Q_ <= 0:
            raise ValueError(f"non-positive grid {grid_size}")
        self.grid_size = (P_, Q_)
        self.order = order
        self._layout = layout
        self._groups = {}
        if P_ * Q_ == 1:
            self.rank, self.coords = 0, (0, 0)
            return
        if world != P_ * Q_:
            raise ValueError(f"grid {grid_size} needs a process group of {P_ * Q_} "
                             f"ranks, have {world}"
                             + ("" if dist.is_initialized() else " (none initialized)"))
        self.rank = dist.get_rank()
        self.coords = self.coords_of(self.rank)
        # every rank creates every subgroup, in the same order
        for axis, n_groups in ((ROW_AXIS, Q_), (COL_AXIS, P_)):
            if self.axis_size(axis) == 1:
                continue
            for other in range(n_groups):
                ranks = self.axis_ranks(axis, other)
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    self._groups[axis] = group

    @classmethod
    def multihost(cls, intra_axis: str = ROW_AXIS, host: Optional[str] = None) -> "Grid":
        """Grid over the ranks of several hosts that keeps the collectives
        along ``intra_axis`` inside one host (counterpart of the JAX
        ``Grid.multihost``, ``dlaf_tpu/comm/mesh.py:49-83``, which does so
        for the devices of several processes). Every rank calls it; the
        ranks are grouped by ``host`` (default ``socket.gethostname()``,
        all-gathered), each host must hold as many ranks, and hosts are
        ordered by their lowest rank. ``ROW_AXIS``: grid (ranks a host,
        hosts), column q holds host q's ranks in rank order; ``COL_AXIS``:
        grid (hosts, ranks a host), row p host p's. Without a process
        group (one rank), the 1x1 grid."""
        if intra_axis not in (ROW_AXIS, COL_AXIS):
            raise ValueError(f"intra_axis must be {ROW_AXIS!r} or {COL_AXIS!r}, "
                             f"got {intra_axis!r}")
        host = socket.gethostname() if host is None else host
        names = collectives.allgather_object(host)
        by_host: dict = {}
        for r, h in enumerate(names):
            by_host.setdefault(h, []).append(r)
        counts = {len(v) for v in by_host.values()}
        if len(counts) != 1:
            raise ValueError("ranks per host must be uniform, got "
                             f"{sorted((h, len(v)) for h, v in by_host.items())}")
        hosts = list(by_host.values())        # in order of each host's lowest rank
        table = np.asarray(hosts, dtype=np.int64)   # (hosts, ranks a host)
        return cls(layout=table.T if intra_axis == ROW_AXIS else table)

    def coords_of(self, rank: int) -> Tuple[int, int]:
        P_, Q_ = self.grid_size
        if self._layout is not None:
            p, q = np.argwhere(self._layout == rank)[0]
            return int(p), int(q)
        return (rank // Q_, rank % Q_) if self.order == "R" else (rank % P_, rank // P_)

    def rank_of(self, p: int, q: int) -> int:
        """Global rank at grid coordinates (p, q)."""
        P_, Q_ = self.grid_size
        if self._layout is not None:
            return int(self._layout[p, q])
        return p * Q_ + q if self.order == "R" else q * P_ + p

    def axis_ranks(self, axis: str, other: Optional[int] = None) -> list:
        """Global ranks along ``axis`` in coordinate order, at the other
        coordinate ``other`` (default: this rank's)."""
        p, q = self.coords
        if axis == ROW_AXIS:
            q = q if other is None else other
            return [self.rank_of(i, q) for i in range(self.grid_size[0])]
        if axis == COL_AXIS:
            p = p if other is None else other
            return [self.rank_of(p, j) for j in range(self.grid_size[1])]
        raise ValueError(f"unknown grid axis {axis!r}")

    def axis_index(self, axis: str) -> int:
        return self.coords[0] if axis == ROW_AXIS else self.coords[1]

    def axis_size(self, axis: str) -> int:
        return self.grid_size[0] if axis == ROW_AXIS else self.grid_size[1]

    def group(self, axis: Optional[str] = None):
        """Process group of ``axis`` (None: the whole grid, the default
        group). Only defined where the axis has more than one rank."""
        return None if axis is None else self._groups[axis]

    @property
    def size(self) -> int:
        return self.grid_size[0] * self.grid_size[1]

    @property
    def nr_rows(self) -> int:
        return self.grid_size[0]

    @property
    def nr_cols(self) -> int:
        return self.grid_size[1]

    def __repr__(self):
        return f"Grid{self.grid_size}"


def _default_grid(n: int) -> Tuple[int, int]:
    """Most-square (P, Q) with P*Q == n."""
    p = int(np.sqrt(n))
    while n % p:
        p -= 1
    return (p, n // p)
