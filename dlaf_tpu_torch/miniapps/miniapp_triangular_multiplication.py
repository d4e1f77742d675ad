"""Triangular multiplication miniapp
(reference ``miniapp/miniapp_triangular_multiplication.cpp``).

PyTorch counterpart of
:mod:`dlaf_tpu.miniapps.miniapp_triangular_multiplication`, local branch:
``trmm`` side L on the triangular solver's operands; GFlop/s with add =
mul = m^2 n / 2, and with ``--check`` max|Y - A B| <= 500 m eps.

Run: ``python -m dlaf_tpu_torch.miniapps.miniapp_triangular_multiplication -n 8192 -b 512 --check``
"""
from __future__ import annotations

import functools

import dlaf_tpu_torch as dt
from dlaf_tpu_torch.types import eps, total_ops

from . import options
from .miniapp_triangular_solver import operands, refuse_grid


def main(argv=None):
    args = options.parser("miniapp_triangular_multiplication").parse_args(argv)
    refuse_grid(args, "triangular multiplication")
    dtype = options.dtype_of(args)
    a, b = operands(args, dtype, options.device_of(args))
    m, n = b.shape
    fn = functools.partial(dt.trmm, a, b, uplo=args.uplo, nb=min(args.block_size, 512))
    flops = total_ops(dtype, m * m * n / 2, m * m * n / 2)

    def check(y):
        res = float((y - a @ b).abs().max())
        return res <= 500 * m * eps(dtype), f"residual {res:.2e}"

    options.run_timed(args, fn, flops, check_fn=check)


if __name__ == "__main__":
    main()
