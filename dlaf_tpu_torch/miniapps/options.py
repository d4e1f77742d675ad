"""Shared miniapp CLI options, timing and output contract.

PyTorch counterpart of :mod:`dlaf_tpu.miniapps.options` (reference
``miniapp/include/dlaf/miniapp/options.h``): the common flags, timing of the
runs after the warm-ups between full device synchronisations, and the
parseable ``CSVData-2`` row, field for field as the JAX miniapps print it.

The device is explicit (``--device``, default ``cuda``): a run asked for
the card fails where there is none, it never moves to the CPU.
``--input-file`` / ``--input-dataset`` load the input from a file of
:mod:`dlaf_tpu_torch.matrix.io` (``.h5``/``.hdf5`` in the reference's
HDF5 layout, else ``.npz``), and ``--output-file`` writes the input and
the results there, as the JAX miniapps do (files are interchangeable
between the two packages).

A grid larger than 1x1 (``--grid-rows``/``--grid-cols``) is a distributed
run: one process per rank, started by ``torchrun --nproc-per-node P*Q``
(or already joined in a process group, as ``comm.launch.spawn_grid``
does). Rank r runs on ``cuda:{r % device_count}``; the process group's
backend is ``--comm-backend``, by default ``init.default_backend``'s: nccl
where every rank has a card of its own, gloo on the CPU or for several
ranks on one card. Only rank 0 prints.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..comm import collectives as coll
from ..comm.launch import rank_device
from ..comm.mesh import Grid
from ..init import default_backend


def parser(name: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=name)
    p.add_argument("--matrix-size", "-n", type=int, default=2048)
    p.add_argument("--block-size", "-b", type=int, default=256)
    p.add_argument("--m", type=int, default=None,
                   help="columns of B (triangular solver/multiplication; default n/2)")
    p.add_argument("--band-size", type=int, default=None,
                   help="eigensolver band (default: get_band_size of the tune "
                        "parameters' default_block_size)")
    p.add_argument("--grid-rows", type=int, default=1)
    p.add_argument("--grid-cols", type=int, default=1)
    p.add_argument("--nruns", type=int, default=3)
    p.add_argument("--nwarmups", type=int, default=1)
    p.add_argument("--check", action="store_true")
    p.add_argument("--type", choices=["s", "d", "c", "z"], default="s",
                   help="s=float32, d=float64, c=complex64, z=complex128")
    p.add_argument("--uplo", choices=["L", "U"], default="L")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; 'cpu' runs the "
                        "plain versions of the kernels)")
    p.add_argument("--comm-backend", choices=["nccl", "gloo"], default=None,
                   help="torch.distributed backend of a distributed run (default: nccl "
                        "where every rank has a card, gloo on cpu or for several ranks "
                        "on one card)")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the timed runs to "
                        "DIR/trace.json (chrome trace format)")
    p.add_argument("--input-file", default=None, metavar="FILE",
                   help="load the input matrix from FILE instead of "
                        "generating it (.h5/.hdf5 in the reference's HDF5 "
                        "layout, else .npz; reference "
                        "miniapp_eigensolver.cpp --input-file)")
    p.add_argument("--input-dataset", default="/input",
                   help="dataset name inside --input-file (default /input)")
    p.add_argument("--output-file", default=None, metavar="FILE",
                   help="write the input matrix and results of the last "
                        "run to FILE (reference --output-file contract: "
                        "input dataset + /evals + /evecs)")
    return p


def load_input(args, default_gen, device, dataset=None) -> torch.Tensor:
    """Input matrix: the ``--input-file`` dataset ``dataset`` (default
    ``--input-dataset``) if a file is given (cast to ``--type``, size from
    the file; every rank reads it), else ``default_gen()``. Returns a
    tensor on ``device`` and sets ``args.matrix_size`` to its order."""
    if not args.input_file:
        return default_gen()
    from ..matrix.io import MatrixFile
    a = MatrixFile(args.input_file).read(dataset or args.input_dataset)
    args.matrix_size = a.shape[0]
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype_of(args))


def write_output(args, **datasets) -> None:
    """``--output-file``: write the (gathered) datasets; rank 0 writes and
    prints the path."""
    if _distributed() and dist.get_rank() != 0:
        return
    from ..matrix.io import MatrixFile
    MatrixFile(args.output_file).write(**datasets)
    print(f"output: {args.output_file}")


def dtype_of(args) -> torch.dtype:
    return {"s": torch.float32, "d": torch.float64,
            "c": torch.complex64, "z": torch.complex128}[args.type]


def _distributed() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def device_of(args) -> torch.device:
    """The run's device; in a distributed run, rank r's card is
    ``cuda:{r % device_count}``."""
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available")
    if dev.type == "cuda" and _distributed():
        dev = rank_device("cuda", dist.get_rank())
    return dev


@contextlib.contextmanager
def process_grid(args):
    """The process grid of a distributed run (``--grid-rows``·``--grid-cols``
    > 1), else None. Joins the process group ``torchrun`` describes unless
    one is already up, and leaves it on exit if it joined it here. Raises
    where the world size is not P·Q, or the group's backend is not the
    ``--comm-backend`` asked for."""
    P, Q = args.grid_rows, args.grid_cols
    if P * Q == 1:
        yield None
        return
    joined = not dist.is_initialized()
    if joined:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world != P * Q:
            raise ValueError(f"grid {P}x{Q} needs {P * Q} ranks, have {world}: run it "
                             f"under torchrun --nproc-per-node {P * Q}")
        backend = args.comm_backend or default_backend(torch.device(args.device).type, world)
        dist.init_process_group(backend, init_method="env://")
    try:
        if args.comm_backend is not None and dist.get_backend() != args.comm_backend:
            raise ValueError(f"--comm-backend {args.comm_backend}: the process group "
                             f"runs {dist.get_backend()}")
        if torch.device(args.device).type == "cuda":
            torch.cuda.set_device(device_of(args))
        yield Grid((P, Q))
    finally:
        if joined:
            dist.destroy_process_group()


def sync(device: torch.device) -> None:
    """Fence: wait until the device has finished all queued work, and in a
    distributed run until every rank has (the reference's
    ``waitLocalTiles`` + ``MPI_Barrier``)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    coll.barrier()


def run_timed(args, fn, flop_count, check_fn=None):
    """Warm-ups + timed runs; prints a per-run line and a CSVData-2 row
    (rank 0 only in a distributed run, where every rank calls it)."""
    device = device_of(args)
    backend = device.type
    rank = dist.get_rank() if _distributed() else 0
    say = print if rank == 0 else (lambda *a, **k: None)
    if args.nwarmups + args.nruns < 1:
        raise ValueError("need at least one run")
    out = None
    prof = None
    for r in range(args.nwarmups + args.nruns):
        if args.trace and r == args.nwarmups:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if backend == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        sync(device)
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        t = time.perf_counter() - t0
        if r < args.nwarmups:
            continue
        run = r - args.nwarmups
        gflops = flop_count / t / 1e9 if flop_count else 0.0
        say(f"[{run}] {t:.6f}s {gflops:.2f}GFlop/s "
            f"({args.matrix_size}, {args.block_size}) "
            f"({args.grid_rows}, {args.grid_cols}) {backend}")
        row = ["CSVData-2", str(run), f"{t:.6f}", f"{gflops:.2f}",
               args.type, args.uplo, str(args.matrix_size),
               str(args.block_size), str(args.grid_rows),
               str(args.grid_cols), "1", backend]
        say(", ".join(row))
    if prof is not None:
        prof.stop()
        os.makedirs(args.trace, exist_ok=True)
        path = os.path.join(args.trace, f"trace.rank{rank}.json" if rank else "trace.json")
        prof.export_chrome_trace(path)
        say(f"trace: {path}")
    if args.check and check_fn is not None:
        ok, msg = check_fn(out)
        say(f"check: {'PASSED' if ok else 'FAILED'} ({msg})")
        if not ok:
            raise SystemExit(1)
    return out
