"""Communication miniapp (reference ``miniapp/miniapp_communication.cpp``).

PyTorch counterpart of :mod:`dlaf_tpu.miniapps.miniapp_communication`:
times the grid collectives the algorithms use, over a process grid of
``--grid-rows`` x ``--grid-cols`` ranks (one process each, as the other
distributed miniapps): the allreduce along the grid's rows and columns
(divided by the axis size, as the JAX miniapp's ``psum``), the ring shift
along the rows (``ring_shift``) and the row all-gather summed over the
gathered axis. Each rank holds one (n, n) tensor on its device, the shard
each JAX device holds of its (P·Q, n, n) array, filled with the rank's
number + 1 (JAX fills ones) so that ``--check`` can hold every result to
its known sums; the lines printed are the JAX miniapp's.

Run: ``python -m dlaf_tpu_torch.miniapps.miniapp_communication -n 2048 --check``
(distributed: ``torchrun --nproc-per-node 4 -m dlaf_tpu_torch.miniapps.miniapp_communication
-n 2048 --grid-rows 2 --grid-cols 2 --check``; only rank 0 prints).
"""
from __future__ import annotations

import time

import torch

from dlaf_tpu_torch.comm import collectives as coll
from dlaf_tpu_torch.comm.mesh import COL_AXIS, ROW_AXIS, Grid

from . import options


def expected(grid: Grid, name: str) -> float:
    """The value every entry of this rank's result of ``name`` must hold."""
    P, Q = grid.grid_size
    p, q = grid.coords
    col = [grid.rank_of(i, q) + 1.0 for i in range(P)]
    row = [grid.rank_of(p, j) + 1.0 for j in range(Q)]
    return {"psum_row": sum(col) / P, "psum_col": sum(row) / Q,
            "ring_row": grid.rank_of((p - 1) % P, q) + 1.0, "allgather_row": sum(col)}[name]


def main(argv=None):
    args = options.parser("miniapp_communication").parse_args(argv)
    dtype = options.dtype_of(args)
    with options.process_grid(args) as grid:
        grid = grid or Grid((1, 1))
        device = options.device_of(args)
        n = args.matrix_size
        P, Q = grid.grid_size
        x = torch.full((n, n), float(grid.rank + 1), dtype=dtype, device=device)
        say = print if grid.rank == 0 else (lambda *a, **k: None)
        bad = []

        def bench(name, op):
            out = op(x)
            options.sync(device)
            t0 = time.perf_counter()
            for _ in range(args.nruns):
                out = op(x)
            options.sync(device)
            t = (time.perf_counter() - t0) / args.nruns
            gb = x.numel() * x.element_size() / 1e9
            say(f"{name}: {t*1e3:.3f} ms  ({gb / t:.2f} GB/s per-shard payload)")
            want = torch.tensor(expected(grid, name), dtype=dtype)
            if args.check and not bool((out == want.to(device)).all()):
                bad.append(name)

        bench("psum_row", lambda v: coll.allreduce_sum(v, ROW_AXIS, grid) / P)
        bench("psum_col", lambda v: coll.allreduce_sum(v, COL_AXIS, grid) / Q)
        bench("ring_row", lambda v: coll.ring_shift(v, ROW_AXIS, grid))
        bench("allgather_row", lambda v: coll.allgather_tiles(v, ROW_AXIS, grid).sum(0))
        if args.check:
            failed = coll.allreduce_max(torch.tensor([float(len(bad))], device=device), None,
                                        grid)
            ok = float(failed[0]) == 0
            say(f"check: {'PASSED' if ok else 'FAILED'} (every result equals its known "
                f"sum on every rank{'' if ok else '; this rank: ' + ', '.join(bad)})")
            if not ok:
                raise SystemExit(1)


if __name__ == "__main__":
    main()
