"""Back-transformation (band to tridiagonal) miniapp
(reference ``miniapp/miniapp_bt_band_to_tridiag.cpp``).

PyTorch counterpart of :mod:`dlaf_tpu.miniapps.miniapp_bt_band_to_tridiag`:
stage 2 (kernel K3 on the card in f32 and complex64) makes the reflector
record of the band of a random hermitian matrix once; each run then
applies it to a random n x n E. Local: ``band_to_tridiag_auto`` and
``bt_band_to_tridiag`` (unshifted, as the JAX local branch calls it: the
grouped WY GEMMs, not K4/K5). On a grid (one process per rank):
``band_to_tridiag_dist``'s sweep-sharded record applied to each rank's
columns of E by ``bt_band_to_tridiag_dist``. With ``--check``, the
commutation band (Q2 E) = Q2 (T E): max|lhs - rhs| <= 200 n eps
max(1, max|band|) max(1, max|E|) (the JAX miniapp checks its local branch
only; here the distributed one too, on the gathered columns).

Run: ``python -m dlaf_tpu_torch.miniapps.miniapp_bt_band_to_tridiag -n 8192 --band-size 128 --check``
(distributed: under ``torchrun --nproc-per-node P*Q`` with ``--grid-rows P --grid-cols Q``)
"""
from __future__ import annotations

import functools

import torch

from dlaf_tpu_torch.algos.eigensolver.band2tridiag import band_to_tridiag_auto
from dlaf_tpu_torch.algos.eigensolver.bt import bt_band_to_tridiag
from dlaf_tpu_torch.algos.eigensolver.dist_stage23 import (band_to_tridiag_dist,
                                                           bt_band_to_tridiag_dist, column_shard,
                                                           gather_columns)
from dlaf_tpu_torch.matrix import generators as gen
from dlaf_tpu_torch.types import eps

from . import options
from .miniapp_band_to_tridiag import band_input, dist_strips, tridiagonal


def main(argv=None):
    args = options.parser("miniapp_bt_band_to_tridiag").parse_args(argv)
    n = args.matrix_size
    band = args.band_size or min(args.block_size, 128)
    dtype = options.dtype_of(args)
    with options.process_grid(args) as grid:
        device = options.device_of(args)
        bandm = band_input(args, dtype, device)
        emat = gen.random_general(torch.Generator(device=device).manual_seed(1), (n, n), dtype)
        if grid is None:
            d, e, vs, taus = band_to_tridiag_auto(bandm, band)
            apply = functools.partial(bt_band_to_tridiag, vs=vs, taus=taus, b=band)
            get = lambda x: x   # noqa: E731
        else:
            d, e, vs, taus = band_to_tridiag_dist(dist_strips(bandm, band), n, band, grid)

            def apply(x):
                return bt_band_to_tridiag_dist(column_shard(x, grid), vs, taus, band, n, grid)

            get = lambda x: gather_columns(x, grid)[:, :n]   # noqa: E731
        fn = functools.partial(apply, emat)

        def check(out):
            # Q2 satisfies band = Q2 T Q2^H, hence band (Q2 E) = Q2 (T E)
            lhs = bandm @ get(out)
            rhs = get(apply(tridiagonal(d, e, dtype) @ emat))
            scale = max(float(bandm.abs().max()), 1.0) * max(float(emat.abs().max()), 1.0)
            err = float((lhs - rhs).abs().max())
            tol = 200 * n * eps(dtype) * scale
            return err <= tol, f"commutation err {err:.2e} tol {tol:.2e}"

        options.run_timed(args, fn, 0, check_fn=check)


if __name__ == "__main__":
    main()
