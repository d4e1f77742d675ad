"""Gen-to-std miniapp (reference ``miniapp/miniapp_gen_to_std.cpp``).

PyTorch counterpart of :mod:`dlaf_tpu.miniapps.miniapp_gen_to_std`, local
branch: ``hegst`` of a random hermitian A against the lower Cholesky
factor of a random hermitian positive definite B (``potrf`` on the card's
K1 in f32); GFlop/s with add = mul = n^3/2, and with ``--check``
max|A_std - L^-1 A L^-H| / max(1, max|ref|) <= 1000 n eps.

Run: ``python -m dlaf_tpu_torch.miniapps.miniapp_gen_to_std -n 8192 -b 512 --check``
"""
from __future__ import annotations

import functools

import torch

import dlaf_tpu_torch as dt
from dlaf_tpu_torch.matrix import generators as gen
from dlaf_tpu_torch.types import eps, total_ops

from . import options
from .miniapp_triangular_solver import refuse_grid


def main(argv=None):
    args = options.parser("miniapp_gen_to_std").parse_args(argv)
    refuse_grid(args, "gen_to_std")
    n, nb = args.matrix_size, min(args.block_size, 512)
    dtype = options.dtype_of(args)
    device = options.device_of(args)
    a = gen.random_hermitian(torch.Generator(device=device).manual_seed(0), n, dtype)
    b = gen.random_hermitian_positive_definite(
        torch.Generator(device=device).manual_seed(1), n, dtype)
    l = dt.potrf(b, nb=nb)
    fn = functools.partial(dt.hegst, a, l, nb=nb)
    flops = total_ops(dtype, n**3 / 2, n**3 / 2)

    def check(out):
        linv = torch.linalg.inv(torch.tril(l))
        ref = linv @ a @ linv.mH
        res = float((out - ref).abs().max()) / max(float(ref.abs().max()), 1.0)
        return res <= 1000 * n * eps(dtype), f"residual {res:.2e}"

    options.run_timed(args, fn, flops, check_fn=check)


if __name__ == "__main__":
    main()
