"""Generalized eigensolver miniapp (reference ``miniapp/miniapp_gen_eigensolver.cpp``).

PyTorch counterpart of :mod:`dlaf_tpu.miniapps.miniapp_gen_eigensolver`:
``eigh_gen`` (local) or ``eigh_gen_dist`` (distributed, one process per
rank, block size ``-b``; only rank 0 prints) of a random hermitian A and a
random hermitian positive definite B (K1 factors B, K3 runs the
eigensolver's stage 2 on the card in f32); wall time per solve, and with
``--check`` the JAX miniapp's gates, max|A X - B X diag(w)| <= 2000 n eps
max(1, max|A|) and max|X^H B X - I| <= 2000 n eps. ``--input-file``
reads A and B (``--input-dataset-a``/``-b``), ``--output-file`` writes
them with /evals and /evecs (``matrix/io.py``).

Local: ``python -m dlaf_tpu_torch.miniapps.miniapp_gen_eigensolver -n 4096 --check``
Distributed: ``torchrun --nproc-per-node 4 -m dlaf_tpu_torch.miniapps.miniapp_gen_eigensolver
-n 4096 -b 512 --grid-rows 2 --grid-cols 2 --check``
"""
from __future__ import annotations

import functools

import torch

import dlaf_tpu_torch as dt
from dlaf_tpu_torch.matrix import generators as gen
from dlaf_tpu_torch.matrix.dist_matrix import DistMatrix
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
    p = options.parser("miniapp_gen_eigensolver")
    # reference miniapp_gen_eigensolver.cpp:279-280 dataset names
    p.add_argument("--input-dataset-a", default="/input-a")
    p.add_argument("--input-dataset-b", default="/input-b")
    args = p.parse_args(argv)
    dtype = options.dtype_of(args)
    with options.process_grid(args) as grid:
        device = options.device_of(args)
        a = options.load_input(args, lambda: gen.random_hermitian(
            torch.Generator(device=device).manual_seed(0), args.matrix_size, dtype), device,
            args.input_dataset_a)
        b = options.load_input(args, lambda: gen.random_hermitian_positive_definite(
            torch.Generator(device=device).manual_seed(1), args.matrix_size, dtype), device,
            args.input_dataset_b)
        if grid is None:
            fn = functools.partial(dt.eigh_gen, a, b, uplo=args.uplo, band=args.band_size)
            get = lambda out: out   # noqa: E731
        else:
            da = DistMatrix.from_global(a, args.block_size, grid)
            db = DistMatrix.from_global(b, args.block_size, grid, pad_identity=True)
            fn = functools.partial(dt.eigh_gen_dist, da, db)
            get = lambda out: (out[0], out[1].to_global())   # noqa: E731

        def check(out):
            w, x = get(out)
            ok, res, borth = check_eigh_gen(a, b, w, x, dtype)
            return ok, f"res {res:.2e} B-orth {borth:.2e}"

        out = options.run_timed(args, fn, 0, check_fn=check)
        if args.output_file:
            # reference contract (miniapp_gen_eigensolver.cpp:208-211)
            w, x = get(out)
            options.write_output(args, **{args.input_dataset_a: a, args.input_dataset_b: b,
                                          "/evals": w, "/evecs": x})


if __name__ == "__main__":
    main()
