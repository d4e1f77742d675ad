"""Single-tile kernel micro-benchmark.

PyTorch counterpart of :mod:`dlaf_tpu.miniapps.kernel_runner` (reference
KernelRunner, ``miniapp/include/dlaf/miniapp/kernel_runner.h``,
``miniapp/kernel/miniapp_laset.cpp``): times one tile kernel over a batch
of ``--count`` independent nb x nb tiles and prints the time per tile and
the rate, with the JAX miniapp's flop accounting.

Kernels: ``potrf`` (the leaf Cholesky: K1 on the card in f32), ``trsm``
(the leaf solve: the tile's inverse, then one GEMM), ``gemm`` (one batched
matmul), ``laset`` (set a constant), ``lacpy`` (copy), ``add`` (masked
alpha-add) and ``ksub`` (K2, C - X^T Y with k = 4 nb, on a copy of C: one
launch, its time spread over the ``--count`` "tiles" as in JAX). JAX runs
a batch as one vmapped launch; K1 takes one tile a launch, so ``potrf`` is
``--count`` K1 launches (and ``trsm`` ``--count`` leaf solves), one after
another. Each timed line names the K1 and K2 launches a run made.

:func:`kernels` is the kernel table, for the tests and ``chip_smoke.py``
to call on inputs of their own (:func:`make_inputs` makes the miniapp's,
from a ``torch.Generator``).

Run: ``python -m dlaf_tpu_torch.miniapps.kernel_runner --kernel potrf -b 512 --count 64``
"""
from __future__ import annotations

import argparse
import time

import torch

from ..ops.core import tril_mask
from ..ops.kernels.potrf import potrf_tile
from ..ops.kernels.trailing import ksub_matmul
from ..ops.leaf import potrf_leaf, trsm_leaf
from . import options

KERNELS = ("potrf", "trsm", "gemm", "laset", "lacpy", "add", "ksub")


def make_inputs(nb: int, count: int, dtype, device) -> dict:
    """The miniapp's inputs: ``count`` standard normal nb x nb tiles, and
    ksub's X and Y (4 nb x nb), from a generator seeded with 0."""
    g = torch.Generator(device=device).manual_seed(0)

    def normal(shape):
        return torch.randn(shape, generator=g, dtype=dtype, device=device)

    return {"tiles": normal((count, nb, nb)), "xk": normal((4 * nb, nb)),
            "yk": normal((4 * nb, nb))}


def _each(fn, *batches):
    """fn on each tile of the batches, one call a tile, into one new batch."""
    out = torch.empty_like(batches[0])
    for i in range(batches[0].shape[0]):
        out[i] = fn(*(b[i] for b in batches))
    return out


def kernels(nb: int, count: int, dtype, device, inputs: dict | None = None) -> dict:
    """{name: (fn, args, flops per tile)}: ``fn(*args)`` runs the kernel
    over the batch and returns its output as a new tensor. ``inputs``
    (default :func:`make_inputs`) holds ``tiles`` (count, nb, nb), ``xk``
    and ``yk`` (4 nb, nb); the SPD and triangular tiles are made from
    ``tiles`` as the JAX miniapp makes them."""
    inputs = inputs or make_inputs(nb, count, dtype, device)
    tiles, xk, yk = inputs["tiles"], inputs["xk"], inputs["yk"]
    eye = torch.eye(nb, dtype=tiles.dtype, device=tiles.device)
    spd = tiles @ tiles.mT + 4 * nb * eye
    tri = torch.tril(tiles) + 4 * eye
    lower = tril_mask(nb, device=tiles.device)
    return {
        "potrf": (lambda a: _each(potrf_leaf, a), (spd,), nb**3 / 3),
        "trsm": (lambda a, b: _each(lambda x, y: trsm_leaf(x, y, left=True, lower=True,
                                                           trans="N", unit=False), a, b),
                 (tri, tiles), nb**3),
        "gemm": (torch.matmul, (tiles, tiles), 2 * nb**3),
        "laset": (lambda a: torch.full_like(a, 0.5), (tiles,), 0),
        "lacpy": (lambda a: a.clone(), (tiles,), 0),
        "add": (lambda a, b: torch.where(lower, b + 0.5 * a, b), (tiles, spd), 0),
        # one fused trailing update (K2 on the card); its flops are spread
        # over the batch, as JAX's per-tile figure does
        "ksub": (lambda c, x, y: ksub_matmul(c.clone(), x, y), (tiles[0], xk, yk),
                 2 * nb * nb * 4 * nb / count),
    }


def main(argv=None):
    p = argparse.ArgumentParser(prog="kernel_runner")
    p.add_argument("--kernel", choices=list(KERNELS), default="gemm")
    p.add_argument("--block-size", "-b", type=int, default=512)
    p.add_argument("--count", type=int, default=64, help="tiles per run")
    p.add_argument("--nruns", type=int, default=3)
    p.add_argument("--nwarmups", type=int, default=1)
    p.add_argument("--type", choices=["s", "d"], default="s")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; 'cpu' runs the plain "
                        "versions of the kernels)")
    args = p.parse_args(argv)
    device = options.device_of(args)
    nb, count = args.block_size, args.count
    dtype = torch.float64 if args.type == "d" else torch.float32
    fn, fargs, flops = kernels(nb, count, dtype, device)[args.kernel]
    for r in range(args.nwarmups + args.nruns):
        k1, k2 = potrf_tile.launches, ksub_matmul.launches
        options.sync(device)
        t0 = time.perf_counter()
        fn(*fargs)
        options.sync(device)
        t = time.perf_counter() - t0
        if r < args.nwarmups:
            continue
        per = t / count
        gflops = flops / per / 1e9 if flops else 0.0
        print(f"[{r - args.nwarmups}] {args.kernel} b={nb} x{count}: {per*1e6:.1f} us/tile "
              f"{gflops:.2f}GFlop/s {device.type} (K1 launches {potrf_tile.launches - k1}, "
              f"K2 launches {ksub_matmul.launches - k2})")


if __name__ == "__main__":
    main()
