"""Gen-to-std miniapp (reference ``miniapp/miniapp_gen_to_std.cpp``).

PyTorch counterpart of :mod:`dlaf_tpu.miniapps.miniapp_gen_to_std`: the
generalized-to-standard transform of a random hermitian A against the
``--uplo`` Cholesky factor of a random hermitian positive definite B
(``potrf`` on the card's K1 in f32); GFlop/s with add = mul = n^3/2, and
with ``--check`` max|A_std - ref| / max(1, max|ref|) <= 1000 n eps, ref =
L^-1 A L^-H (U^-H A U^-1 for uplo U). Local: ``hegst``. Distributed (one
process per rank, B factored locally on every rank):
``generalized_to_standard_dist`` on block-cyclic ``DistMatrix`` operands
of block size ``-b``; only rank 0 prints. Unlike the JAX miniapp, both
branches pass ``--uplo`` on.

Local: ``python -m dlaf_tpu_torch.miniapps.miniapp_gen_to_std -n 8192 -b 512 --check``
Distributed: under ``torchrun --nproc-per-node P*Q`` with ``--grid-rows P --grid-cols Q``.
"""
from __future__ import annotations

import functools

import torch

import dlaf_tpu_torch as dt
from dlaf_tpu_torch.algos.gen_to_std import generalized_to_standard_dist
from dlaf_tpu_torch.matrix import generators as gen
from dlaf_tpu_torch.matrix.dist_matrix import DistMatrix
from dlaf_tpu_torch.types import eps, total_ops

from . import options


def main(argv=None):
    args = options.parser("miniapp_gen_to_std").parse_args(argv)
    n, nb = args.matrix_size, args.block_size
    dtype = options.dtype_of(args)
    lower = args.uplo == "L"
    with options.process_grid(args) as grid:
        device = options.device_of(args)
        a = gen.random_hermitian(torch.Generator(device=device).manual_seed(0), n, dtype)
        b = gen.random_hermitian_positive_definite(
            torch.Generator(device=device).manual_seed(1), n, dtype)
        l = dt.potrf(b, uplo=args.uplo, nb=min(nb, 512))
        l = torch.tril(l) if lower else torch.triu(l)
        del b
        if grid is None:
            fn = functools.partial(dt.hegst, a, l, uplo=args.uplo, nb=min(nb, 512))
            get = lambda out: out   # noqa: E731
        else:
            da = DistMatrix.from_global(a, nb, grid)
            dl = DistMatrix.from_global(l, nb, grid, pad_identity=True)
            fn = functools.partial(generalized_to_standard_dist, da, dl, uplo=args.uplo)
            get = DistMatrix.to_global
        flops = total_ops(dtype, n**3 / 2, n**3 / 2)

        def check(out):
            linv = torch.linalg.inv(l if lower else l.mH)
            ref = linv @ a @ linv.mH
            res = float((get(out) - ref).abs().max()) / max(float(ref.abs().max()), 1.0)
            return res <= 1000 * n * eps(dtype), f"residual {res:.2e}"

        options.run_timed(args, fn, flops, check_fn=check)


if __name__ == "__main__":
    main()
