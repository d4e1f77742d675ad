"""Triangular solver miniapp (reference ``miniapp/miniapp_triangular_solver.cpp``).

PyTorch counterpart of :mod:`dlaf_tpu.miniapps.miniapp_triangular_solver`:
the solve side L of a well-conditioned random triangular A of order m
against m/2 (``--m``) right-hand sides; GFlop/s with add = mul = m^2 n / 2,
and with ``--check`` max|A X - B| <= 500 m eps. Local: ``trsm``.
Distributed (one process per rank, the same operands on every rank):
``triangular_solver`` on block-cyclic ``DistMatrix`` operands of block
size ``-b``; only rank 0 prints.

Local: ``python -m dlaf_tpu_torch.miniapps.miniapp_triangular_solver -n 8192 -b 512 --check``
(``--device cpu`` runs on the CPU).
Distributed: ``torchrun --nproc-per-node 4 -m dlaf_tpu_torch.miniapps.miniapp_triangular_solver
-n 8192 -b 512 --grid-rows 2 --grid-cols 2 --check`` (``--comm-backend gloo`` for several
ranks on one card, ``--device cpu`` on the CPU).
"""
from __future__ import annotations

import functools

import torch

import dlaf_tpu_torch as dt
from dlaf_tpu_torch.algos.triangular import triangular_solver
from dlaf_tpu_torch.matrix import generators as gen
from dlaf_tpu_torch.matrix.dist_matrix import DistMatrix
from dlaf_tpu_torch.types import eps, total_ops

from . import options


def operands(args, dtype, device):
    """The miniapps' A (random triangular, order m, seed 0) and B (m x n,
    seed 1), n = ``--m`` or m/2."""
    m = args.matrix_size
    n = args.m or m // 2 or 1
    a = gen.random_triangular(torch.Generator(device=device).manual_seed(0), m, dtype,
                              lower=(args.uplo == "L"))
    b = gen.random_general(torch.Generator(device=device).manual_seed(1), (m, n), dtype)
    return a, b


def main(argv=None):
    args = options.parser("miniapp_triangular_solver").parse_args(argv)
    dtype = options.dtype_of(args)
    with options.process_grid(args) as grid:
        a, b = operands(args, dtype, options.device_of(args))
        m, n = b.shape
        if grid is None:
            fn = functools.partial(dt.trsm, a, b, uplo=args.uplo, nb=min(args.block_size, 512))
            get = lambda x: x   # noqa: E731
        else:
            da = DistMatrix.from_global(a, args.block_size, grid, pad_identity=True)
            db = DistMatrix.from_global(b, args.block_size, grid)
            fn = functools.partial(triangular_solver, da, db, uplo=args.uplo)
            get = DistMatrix.to_global
        flops = total_ops(dtype, m * m * n / 2, m * m * n / 2)

        def check(out):
            res = float((a @ get(out) - b).abs().max())
            return res <= 500 * m * eps(dtype), f"residual {res:.2e}"

        options.run_timed(args, fn, flops, check_fn=check)


if __name__ == "__main__":
    main()
