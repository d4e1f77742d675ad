"""Tridiagonal divide-and-conquer miniapp (reference ``miniapp/miniapp_tridiag_solver.cpp``).

PyTorch counterpart of :mod:`dlaf_tpu.miniapps.miniapp_tridiag_solver`,
local branch: ``tridiag_eigh`` of a random symmetric tridiagonal matrix
(diagonal seed 0, off-diagonal seed 1, uniform in [-1, 1]); wall time per
solve, and with ``--check`` max|Q^T Q - I| <= 500 n eps and
max|T Q - Q diag(lambda)| <= 500 n eps. The tridiagonal is real: for
``--type c``/``z`` it is made in the matching real type (f32/f64).
``--input-file`` waits for ``matrix/io.py``.

Run: ``python -m dlaf_tpu_torch.miniapps.miniapp_tridiag_solver -n 8192 --check``
"""
from __future__ import annotations

import functools

import torch

from dlaf_tpu_torch.algos.eigensolver.tridiag_dc import tridiag_eigh
from dlaf_tpu_torch.matrix import generators as gen
from dlaf_tpu_torch.types import eps, real_dtype

from . import options


def main(argv=None):
    args = options.parser("miniapp_tridiag_solver").parse_args(argv)
    options.refuse_grid(args, "tridiagonal solver", "tridiag_dc_dist")
    n = args.matrix_size
    dtype = real_dtype(options.dtype_of(args))
    device = options.device_of(args)
    d = gen.random_general(torch.Generator(device=device).manual_seed(0), (n,), dtype)
    e = gen.random_general(torch.Generator(device=device).manual_seed(1), (max(n - 1, 1),),
                           dtype)[:n - 1]
    fn = functools.partial(tridiag_eigh, d, e)

    def check(out):
        lam, q = out
        t = torch.diag(d) + torch.diag(e, 1) + torch.diag(e, -1)
        orth = float((q.T @ q - torch.eye(n, dtype=dtype, device=device)).abs().max())
        res = float((t @ q - q * lam[None, :]).abs().max())
        ok = orth <= 500 * n * eps(dtype) and res <= 500 * n * eps(dtype)
        return ok, f"orth {orth:.2e} res {res:.2e}"

    options.run_timed(args, fn, 0, check_fn=check)


if __name__ == "__main__":
    main()
