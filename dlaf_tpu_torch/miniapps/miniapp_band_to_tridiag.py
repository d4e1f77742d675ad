"""Band-to-tridiagonal miniapp (reference ``miniapp/miniapp_band_to_tridiag.cpp``).

PyTorch counterpart of :mod:`dlaf_tpu.miniapps.miniapp_band_to_tridiag`,
local branch: stage 2 of the eigensolver on the band (``--band-size``,
default min(block size, 128)) of a random hermitian matrix, through
``band_to_tridiag_auto``: kernel K3 on a CUDA tensor of f32 or complex64
(one launch a run), the plain routes elsewhere. With ``--check``: the
eigenvalues of the tridiagonal against those of the band matrix,
max|ev - ref| / max(1, max|ref|) <= 500 n eps.

Run: ``python -m dlaf_tpu_torch.miniapps.miniapp_band_to_tridiag -n 8192 --band-size 128 --check``
"""
from __future__ import annotations

import functools

import torch

from dlaf_tpu_torch.algos.eigensolver.band2tridiag import band_to_tridiag_auto
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


def main(argv=None):
    args = options.parser("miniapp_band_to_tridiag").parse_args(argv)
    options.refuse_grid(args, "band to tridiagonal", "dist_stage23")
    n = args.matrix_size
    band = args.band_size or min(args.block_size, 128)
    dtype = options.dtype_of(args)
    bandm = band_input(args, dtype, options.device_of(args))
    fn = functools.partial(band_to_tridiag_auto, bandm, band)

    def check(out):
        d, e, _, _ = out
        ev = torch.linalg.eigvalsh(tridiagonal(d, e, dtype))
        ref = torch.linalg.eigvalsh(bandm)
        err = float((ev - ref).abs().max()) / max(float(ref.abs().max()), 1.0)
        return err <= 500 * n * eps(dtype), f"eig err {err:.2e}"

    options.run_timed(args, fn, 0, check_fn=check)


if __name__ == "__main__":
    main()
