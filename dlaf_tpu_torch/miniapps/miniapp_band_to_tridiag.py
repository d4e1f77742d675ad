"""Band-to-tridiagonal miniapp (reference ``miniapp/miniapp_band_to_tridiag.cpp``).

PyTorch counterpart of :mod:`dlaf_tpu.miniapps.miniapp_band_to_tridiag`:
stage 2 of the eigensolver on the band (``--band-size``, default
min(block size, 128)) of a random hermitian matrix. Local:
``band_to_tridiag_auto``, kernel K3 on a CUDA tensor of f32 or complex64
(one launch a run), the plain routes elsewhere. On a grid (one process per
rank): ``band_to_tridiag_dist`` on the replicated strips, every rank
chasing the band (K3 once a rank and run on the card) and recording its
sweep chunk. With ``--check``: the eigenvalues of the tridiagonal against
those of the band matrix, max|ev - ref| / max(1, max|ref|) <= 500 n eps.

Run: ``python -m dlaf_tpu_torch.miniapps.miniapp_band_to_tridiag -n 8192 --band-size 128 --check``
(distributed: under ``torchrun --nproc-per-node P*Q`` with ``--grid-rows P --grid-cols Q``)
"""
from __future__ import annotations

import functools

import torch

from dlaf_tpu_torch.algos.eigensolver.band2tridiag import band_to_tridiag_auto
from dlaf_tpu_torch.algos.eigensolver.band_strips import STRIP_W, band_to_strips
from dlaf_tpu_torch.algos.eigensolver.dist_stage23 import band_to_tridiag_dist
from dlaf_tpu_torch.matrix import generators as gen
from dlaf_tpu_torch.types import eps

from . import options


def band_input(args, dtype, device) -> torch.Tensor:
    """The band miniapps' input: a random hermitian matrix (seed 0) with
    the entries outside the band zeroed."""
    n = args.matrix_size
    band = args.band_size or min(args.block_size, 128)
    a = gen.random_hermitian(torch.Generator(device=device).manual_seed(0), n, dtype)
    rows = torch.arange(n, device=device)
    return torch.where((rows[:, None] - rows[None, :]).abs() <= band, a, 0)


def tridiagonal(d: torch.Tensor, e: torch.Tensor, dtype) -> torch.Tensor:
    """The dense hermitian tridiagonal matrix of (d, e), in ``dtype``."""
    return torch.diag(d.to(dtype)) + torch.diag(e, -1) + torch.diag(e.conj(), 1)


def dist_strips(bandm: torch.Tensor, band: int) -> torch.Tensor:
    """Strip storage of the band with the three trailing dead strips that
    the distributed stage 2 takes (as ``strips_from_packed_dist`` makes)."""
    strips = band_to_strips(bandm, band)
    return torch.cat([strips, strips.new_zeros((3, band, STRIP_W * band))])


def main(argv=None):
    args = options.parser("miniapp_band_to_tridiag").parse_args(argv)
    n = args.matrix_size
    band = args.band_size or min(args.block_size, 128)
    dtype = options.dtype_of(args)
    with options.process_grid(args) as grid:
        bandm = band_input(args, dtype, options.device_of(args))
        if grid is None:
            fn = functools.partial(band_to_tridiag_auto, bandm, band)
        else:
            fn = functools.partial(band_to_tridiag_dist, dist_strips(bandm, band), n, band, grid)

        def check(out):
            d, e, _, _ = out
            ev = torch.linalg.eigvalsh(tridiagonal(d, e, dtype))
            ref = torch.linalg.eigvalsh(bandm)
            err = float((ev - ref).abs().max()) / max(float(ref.abs().max()), 1.0)
            return err <= 500 * n * eps(dtype), f"eig err {err:.2e}"

        options.run_timed(args, fn, 0, check_fn=check)


if __name__ == "__main__":
    main()
