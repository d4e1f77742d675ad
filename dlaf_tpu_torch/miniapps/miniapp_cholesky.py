"""Cholesky miniapp (reference ``miniapp/miniapp_cholesky.cpp``).

PyTorch counterpart of :mod:`dlaf_tpu.miniapps.miniapp_cholesky`, local
branch: GFlop/s = total_ops(n^3/6 add, n^3/6 mul)/t, and with ``--check``
the residual max|A - L L^H|/n against 100 n eps.

Run: ``python -m dlaf_tpu_torch.miniapps.miniapp_cholesky -n 8192 -b 256 --check``
"""
from __future__ import annotations

import functools

import torch

import dlaf_tpu_torch as dt
from dlaf_tpu_torch.matrix import generators as gen
from dlaf_tpu_torch.types import eps, total_ops

from . import options


def main(argv=None):
    args = options.parser("miniapp_cholesky").parse_args(argv)
    if args.grid_rows * args.grid_cols > 1:
        raise NotImplementedError(
            "distributed Cholesky is not ported yet (ROADMAP Queue 1 items 7-8: "
            "the distributed data model, then algos/cholesky.py with kernel K6)")
    n, nb = args.matrix_size, args.block_size
    dtype = options.dtype_of(args)
    device = options.device_of(args)
    a = gen.random_hermitian_positive_definite(
        torch.Generator(device=device).manual_seed(0), n, dtype)
    fn = functools.partial(dt.potrf, a, uplo=args.uplo, nb=min(nb, 512))
    flops = total_ops(dtype, n**3 / 6, n**3 / 6)

    def check(f):
        rec = f @ f.mH if args.uplo == "L" else f.mH @ f
        res = float((rec - a).abs().max()) / max(n, 1)
        return res <= 100 * n * eps(dtype), f"residual {res:.2e}"

    options.run_timed(args, fn, flops, check_fn=check)


if __name__ == "__main__":
    main()
