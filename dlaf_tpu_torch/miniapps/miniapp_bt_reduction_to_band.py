"""Back-transformation (reduction to band) miniapp
(reference ``miniapp/miniapp_bt_reduction_to_band.cpp``).

PyTorch counterpart of :mod:`dlaf_tpu.miniapps.miniapp_bt_reduction_to_band`,
local branch: stage 1 (``reduction_to_band``) of a random hermitian A once;
each run applies its reflectors to a random n x n E
(``bt_reduction_to_band``); GFlop/s with add = mul = 2 n^3. With
``--check``, the commutation A (Q E) = Q (B E), B the band form:
max|lhs - rhs| <= 200 n eps max(1, max|A|) max(1, max|E|). Every product
is a full-precision one (TF32 is off, ``ops/core.py``), as the JAX
miniapp pins its check's products to f32.

Run: ``python -m dlaf_tpu_torch.miniapps.miniapp_bt_reduction_to_band -n 8192 --band-size 128 --check``
"""
from __future__ import annotations

import functools

import torch

from dlaf_tpu_torch.algos.eigensolver.bt import bt_reduction_to_band
from dlaf_tpu_torch.algos.eigensolver.red2band import extract_band, reduction_to_band
from dlaf_tpu_torch.matrix import generators as gen
from dlaf_tpu_torch.types import eps, total_ops

from . import options


def main(argv=None):
    args = options.parser("miniapp_bt_reduction_to_band").parse_args(argv)
    options.refuse_grid(args, "back-transformation (reduction to band)",
                        "dist_red2band and dist_stage23")
    n = args.matrix_size
    band = args.band_size or min(args.block_size, 128)
    if n % band:
        raise SystemExit("matrix-size must be a multiple of band-size")
    dtype = options.dtype_of(args)
    device = options.device_of(args)
    a = gen.random_hermitian(torch.Generator(device=device).manual_seed(0), n, dtype)
    emat = gen.random_general(torch.Generator(device=device).manual_seed(1), (n, n), dtype)
    packed, taus = reduction_to_band(a, band)
    fn = functools.partial(bt_reduction_to_band, emat, packed, taus, band)

    def check(out):
        # Q satisfies A = Q B Q^H (B the band form), hence A (Q E) = Q (B E)
        lhs = (torch.tril(a) + torch.tril(a, -1).mH) @ out
        rhs = bt_reduction_to_band(extract_band(packed, band) @ emat, packed, taus, band)
        scale = max(float(a.abs().max()), 1.0) * max(float(emat.abs().max()), 1.0)
        err = float((lhs - rhs).abs().max())
        tol = 200 * n * eps(dtype) * scale
        return err <= tol, f"commutation err {err:.2e} tol {tol:.2e}"

    flops = total_ops(dtype, 2 * n**3, 2 * n**3)   # ~4 n^2 nev with nev = n
    options.run_timed(args, fn, flops, check_fn=check)


if __name__ == "__main__":
    main()
