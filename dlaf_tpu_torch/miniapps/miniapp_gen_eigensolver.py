"""Generalized eigensolver miniapp (reference ``miniapp/miniapp_gen_eigensolver.cpp``).

PyTorch counterpart of :mod:`dlaf_tpu.miniapps.miniapp_gen_eigensolver`,
local branch: ``eigh_gen`` of a random hermitian A and a random hermitian
positive definite B (K1 factors B, K3 runs the eigensolver's stage 2 on
the card in f32); wall time per solve, and with ``--check`` the JAX
miniapp's gates, max|A X - B X diag(w)| <= 2000 n eps max(1, max|A|) and
max|X^H B X - I| <= 2000 n eps. ``--input-file`` waits for
``matrix/io.py``.

Run: ``python -m dlaf_tpu_torch.miniapps.miniapp_gen_eigensolver -n 4096 --check``
"""
from __future__ import annotations

import functools

import torch

import dlaf_tpu_torch as dt
from dlaf_tpu_torch.matrix import generators as gen
from dlaf_tpu_torch.types import eps

from . import options


def check_eigh_gen(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor, x: torch.Tensor, dtype):
    """The miniapp's gates on (w, x) of the pencil (a, b), computed in the
    working precision on a's device: (passed, res, borth)."""
    n = a.shape[0]
    c = max(float(a.abs().max()), 1.0)
    res = float((a @ x - (b @ x) * w.to(x.dtype)[None, :]).abs().max())
    borth = float((x.mH @ b @ x - torch.eye(n, dtype=x.dtype, device=x.device)).abs().max())
    ok = res <= 2000 * n * eps(dtype) * c and borth <= 2000 * n * eps(dtype)
    return ok, res, borth


def main(argv=None):
    args = options.parser("miniapp_gen_eigensolver").parse_args(argv)
    options.refuse_grid(args, "generalized eigensolver",
                        "the distributed eigensolver and eigh_gen_dist")
    n = args.matrix_size
    dtype = options.dtype_of(args)
    device = options.device_of(args)
    a = gen.random_hermitian(torch.Generator(device=device).manual_seed(0), n, dtype)
    b = gen.random_hermitian_positive_definite(
        torch.Generator(device=device).manual_seed(1), n, dtype)
    fn = functools.partial(dt.eigh_gen, a, b, uplo=args.uplo, band=args.band_size)

    def check(out):
        ok, res, borth = check_eigh_gen(a, b, out[0], out[1], dtype)
        return ok, f"res {res:.2e} B-orth {borth:.2e}"

    options.run_timed(args, fn, 0, check_fn=check)


if __name__ == "__main__":
    main()
