"""Shared miniapp CLI options, timing and output contract.

PyTorch counterpart of :mod:`dlaf_tpu.miniapps.options` (reference
``miniapp/include/dlaf/miniapp/options.h``): the common flags, timing of the
runs after the warm-ups between full device synchronisations, and the
parseable ``CSVData-2`` row, field for field as the JAX miniapps print it.

The device is explicit (``--device``, default ``cuda``): a run asked for
the card fails where there is none, it never moves to the CPU. Options that
only other miniapps read (``--m``, ``--band-size``) and ``--input-file`` /
``--output-file`` (which need ``matrix/io.py``) come with later slices.
"""
from __future__ import annotations

import argparse
import os
import time

import torch


def parser(name: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=name)
    p.add_argument("--matrix-size", "-n", type=int, default=2048)
    p.add_argument("--block-size", "-b", type=int, default=256)
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
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the timed runs to "
                        "DIR/trace.json (chrome trace format)")
    return p


def dtype_of(args) -> torch.dtype:
    return {"s": torch.float32, "d": torch.float64,
            "c": torch.complex64, "z": torch.complex128}[args.type]


def device_of(args) -> torch.device:
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available")
    return dev


def sync(device: torch.device) -> None:
    """Fence: wait until the device has finished all queued work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_timed(args, fn, flop_count, check_fn=None):
    """Warm-ups + timed runs; prints a per-run line and a CSVData-2 row."""
    device = device_of(args)
    backend = device.type
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
        print(f"[{run}] {t:.6f}s {gflops:.2f}GFlop/s "
              f"({args.matrix_size}, {args.block_size}) "
              f"({args.grid_rows}, {args.grid_cols}) {backend}")
        row = ["CSVData-2", str(run), f"{t:.6f}", f"{gflops:.2f}",
               args.type, args.uplo, str(args.matrix_size),
               str(args.block_size), str(args.grid_rows),
               str(args.grid_cols), "1", backend]
        print(", ".join(row))
    if prof is not None:
        prof.stop()
        os.makedirs(args.trace, exist_ok=True)
        path = os.path.join(args.trace, "trace.json")
        prof.export_chrome_trace(path)
        print(f"trace: {path}")
    if args.check and check_fn is not None:
        ok, msg = check_fn(out)
        print(f"check: {'PASSED' if ok else 'FAILED'} ({msg})")
        if not ok:
            raise SystemExit(1)
    return out
