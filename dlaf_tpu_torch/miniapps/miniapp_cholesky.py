"""Cholesky miniapp (reference ``miniapp/miniapp_cholesky.cpp``).

PyTorch counterpart of :mod:`dlaf_tpu.miniapps.miniapp_cholesky`:
GFlop/s = total_ops(n^3/6 add, n^3/6 mul)/t, and with ``--check`` the
residual max|A - L L^H|/n against 100 n eps.

Local: ``python -m dlaf_tpu_torch.miniapps.miniapp_cholesky -n 8192 -b 256 --check``
Distributed (``cholesky`` on a block-cyclic ``DistMatrix``, one process per
rank): ``torchrun --nproc-per-node 4 -m dlaf_tpu_torch.miniapps.miniapp_cholesky
-n 8192 -b 512 --grid-rows 2 --grid-cols 2 --check`` (``--comm-backend gloo``
for several ranks on one card).
"""
from __future__ import annotations

import functools

import torch

import dlaf_tpu_torch as dt
from dlaf_tpu_torch.algos.cholesky import cholesky
from dlaf_tpu_torch.matrix import generators as gen
from dlaf_tpu_torch.matrix.dist_matrix import DistMatrix
from dlaf_tpu_torch.types import eps, total_ops

from . import options


def main(argv=None):
    args = options.parser("miniapp_cholesky").parse_args(argv)
    n, nb = args.matrix_size, args.block_size
    dtype = options.dtype_of(args)
    with options.process_grid(args) as grid:
        device = options.device_of(args)
        # every rank makes the same matrix (the replicated-input convention)
        a = gen.random_hermitian_positive_definite(
            torch.Generator(device=device).manual_seed(0), n, dtype)
        if grid is None:
            fn = functools.partial(dt.potrf, a, uplo=args.uplo, nb=min(nb, 512))
            get = lambda f: f   # noqa: E731
        else:
            dm = DistMatrix.from_global(a, nb, grid, pad_identity=True)
            fn = functools.partial(cholesky, dm, uplo=args.uplo)
            tri = torch.tril if args.uplo == "L" else torch.triu
            get = lambda out: tri(out.to_global())   # noqa: E731
        flops = total_ops(dtype, n**3 / 6, n**3 / 6)

        def check(out):
            f = get(out)
            rec = f @ f.mH if args.uplo == "L" else f.mH @ f
            res = float((rec - a).abs().max()) / max(n, 1)
            return res <= 100 * n * eps(dtype), f"residual {res:.2e}"

        options.run_timed(args, fn, flops, check_fn=check)


if __name__ == "__main__":
    main()
