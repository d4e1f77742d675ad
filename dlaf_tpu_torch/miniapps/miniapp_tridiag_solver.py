"""Tridiagonal divide-and-conquer miniapp (reference ``miniapp/miniapp_tridiag_solver.cpp``).

PyTorch counterpart of :mod:`dlaf_tpu.miniapps.miniapp_tridiag_solver`:
``tridiag_eigh`` (local), or on a grid (one process per rank)
``tridiag_eigh_dist`` where ``dc_dist_supported`` holds (else the local
solver on every rank, as the JAX miniapp does), of a random symmetric
tridiagonal matrix
(diagonal seed 0, off-diagonal seed 1, uniform in [-1, 1]); wall time per
solve, and with ``--check`` max|Q^T Q - I| <= 500 n eps and
max|T Q - Q diag(lambda)| <= 500 n eps. The tridiagonal is real: for
``--type c``/``z`` it is made in the matching real type (f32/f64).
``--input-file`` reads d and e from an (n, 2) dataset (default
/tridiag), as the JAX miniapp does.

Run: ``python -m dlaf_tpu_torch.miniapps.miniapp_tridiag_solver -n 8192 --check``
(distributed: under ``torchrun --nproc-per-node P*Q`` with ``--grid-rows P --grid-cols Q``)
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from dlaf_tpu_torch.algos.eigensolver.dist_stage23 import gather_columns
from dlaf_tpu_torch.algos.eigensolver.tridiag_dc import tridiag_eigh
from dlaf_tpu_torch.algos.eigensolver.tridiag_dc_dist import dc_dist_supported, tridiag_eigh_dist
from dlaf_tpu_torch.matrix import generators as gen
from dlaf_tpu_torch.types import eps, real_dtype

from . import options


def main(argv=None):
    p = options.parser("miniapp_tridiag_solver")
    p.set_defaults(input_dataset="/tridiag")  # reference default dataset
    args = p.parse_args(argv)
    dtype = real_dtype(options.dtype_of(args))
    with options.process_grid(args) as grid:
        device = options.device_of(args)
        if args.input_file:
            # reference layout (miniapp_tridiag_solver.cpp:109): an (n, 2) real
            # matrix, column 0 = diagonal, column 1 = off-diagonal (last unused)
            from dlaf_tpu_torch.matrix.io import MatrixFile
            td = torch.from_numpy(np.ascontiguousarray(
                MatrixFile(args.input_file).read(args.input_dataset)))
            args.matrix_size = td.shape[0]
            d = td[:, 0].to(device, dtype)
            e = td[:-1, 1].to(device, dtype)
        else:
            n = args.matrix_size
            d = gen.random_general(torch.Generator(device=device).manual_seed(0), (n,), dtype)
            e = gen.random_general(torch.Generator(device=device).manual_seed(1),
                                   (max(n - 1, 1),), dtype)[:n - 1]
        n = args.matrix_size
        if grid is not None and dc_dist_supported(n, grid.size):
            fn = functools.partial(tridiag_eigh_dist, d, e, grid)
            get = lambda out: (out[0][:n], gather_columns(out[1], grid)[:n, :n])   # noqa: E731
        else:
            fn = functools.partial(tridiag_eigh, d, e)
            get = lambda out: out   # noqa: E731

        def check(out):
            lam, q = get(out)
            t = torch.diag(d) + torch.diag(e, 1) + torch.diag(e, -1)
            orth = float((q.T @ q - torch.eye(n, dtype=dtype, device=device)).abs().max())
            res = float((t @ q - q * lam[None, :]).abs().max())
            ok = orth <= 500 * n * eps(dtype) and res <= 500 * n * eps(dtype)
            return ok, f"orth {orth:.2e} res {res:.2e}"

        options.run_timed(args, fn, 0, check_fn=check)


if __name__ == "__main__":
    main()
