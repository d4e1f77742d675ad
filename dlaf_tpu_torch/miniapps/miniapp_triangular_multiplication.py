"""Triangular multiplication miniapp
(reference ``miniapp/miniapp_triangular_multiplication.cpp``).

PyTorch counterpart of
:mod:`dlaf_tpu.miniapps.miniapp_triangular_multiplication`: side L on the
triangular solver's operands; GFlop/s with add = mul = m^2 n / 2, and with
``--check`` max|Y - A B| <= 500 m eps. Local: ``trmm``. Distributed (one
process per rank): ``triangular_multiplication`` on block-cyclic
``DistMatrix`` operands of block size ``-b``; only rank 0 prints.

Local: ``python -m dlaf_tpu_torch.miniapps.miniapp_triangular_multiplication -n 8192 -b 512 --check``
Distributed: under ``torchrun --nproc-per-node P*Q`` with ``--grid-rows P --grid-cols Q``.
"""
from __future__ import annotations

import functools

import dlaf_tpu_torch as dt
from dlaf_tpu_torch.algos.general import triangular_multiplication
from dlaf_tpu_torch.matrix.dist_matrix import DistMatrix
from dlaf_tpu_torch.types import eps, total_ops

from . import options
from .miniapp_triangular_solver import operands


def main(argv=None):
    args = options.parser("miniapp_triangular_multiplication").parse_args(argv)
    dtype = options.dtype_of(args)
    with options.process_grid(args) as grid:
        a, b = operands(args, dtype, options.device_of(args))
        m, n = b.shape
        if grid is None:
            fn = functools.partial(dt.trmm, a, b, uplo=args.uplo, nb=min(args.block_size, 512))
            get = lambda y: y   # noqa: E731
        else:
            da = DistMatrix.from_global(a, args.block_size, grid)
            db = DistMatrix.from_global(b, args.block_size, grid)
            fn = functools.partial(triangular_multiplication, da, db, uplo=args.uplo)
            get = DistMatrix.to_global
        flops = total_ops(dtype, m * m * n / 2, m * m * n / 2)

        def check(out):
            res = float((get(out) - a @ b).abs().max())
            return res <= 500 * m * eps(dtype), f"residual {res:.2e}"

        options.run_timed(args, fn, flops, check_fn=check)


if __name__ == "__main__":
    main()
