"""Eigensolver miniapp (reference ``miniapp/miniapp_eigensolver.cpp``).

PyTorch counterpart of :mod:`dlaf_tpu.miniapps.miniapp_eigensolver`, local
branch: wall time per solve, and with ``--check`` the gates of the JAX
miniapp, max|V^H V - I| <= 500 n eps and max|A V - V diag(w)| <=
1000 n eps max(1, max|A|).

Run: ``python -m dlaf_tpu_torch.miniapps.miniapp_eigensolver -n 4096 --check``
(``--device cpu`` runs the plain versions of the kernels).
"""
from __future__ import annotations

import functools

import torch

import dlaf_tpu_torch as dt
from dlaf_tpu_torch.matrix import generators as gen
from dlaf_tpu_torch.types import eps

from . import options


def check_eigh(a: torch.Tensor, w: torch.Tensor, v: torch.Tensor, dtype):
    """The miniapp's gates on (w, v) of hermitian ``a``, computed in the
    working precision on a's device: (passed, orth, res)."""
    n = a.shape[0]
    c = max(float(a.abs().max()), 1.0)
    orth = float((v.mH @ v - torch.eye(n, dtype=v.dtype, device=v.device)).abs().max())
    res = float((a @ v - v * w.to(v.dtype)[None, :]).abs().max())
    ok = orth <= 500 * n * eps(dtype) and res <= 1000 * n * eps(dtype) * c
    return ok, orth, res


def main(argv=None):
    args = options.parser("miniapp_eigensolver").parse_args(argv)
    if args.grid_rows * args.grid_cols > 1:
        raise NotImplementedError(
            "the distributed eigensolver is not ported yet (ROADMAP Queue 1 items 7-8: "
            "the distributed data model, then dist_red2band, dist_stage23 and "
            "dist_driver)")
    n = args.matrix_size
    dtype = options.dtype_of(args)
    device = options.device_of(args)
    a = gen.random_hermitian(torch.Generator(device=device).manual_seed(0), n, dtype)
    fn = functools.partial(dt.eigh, a, uplo=args.uplo, band=args.band_size)

    def check(out):
        ok, orth, res = check_eigh(a, out[0], out[1], dtype)
        return ok, f"orth {orth:.2e} res {res:.2e}"

    options.run_timed(args, fn, 0, check_fn=check)


if __name__ == "__main__":
    main()
