"""Eigensolver miniapp (reference ``miniapp/miniapp_eigensolver.cpp``).

PyTorch counterpart of :mod:`dlaf_tpu.miniapps.miniapp_eigensolver`:
wall time per solve, and with ``--check`` the gates of the JAX miniapp,
max|V^H V - I| <= 500 n eps and max|A V - V diag(w)| <= 1000 n eps
max(1, max|A|). Local: ``eigh``. Distributed (one process per rank):
``eigh_dist`` on a block-cyclic ``DistMatrix`` of block size ``-b``
(kernel K3 in every rank's stage 2 on the card); only rank 0 prints.
``--input-file``/``--input-dataset`` read A from a file, ``--output-file``
writes A, /evals and /evecs (``matrix/io.py``).

Local: ``python -m dlaf_tpu_torch.miniapps.miniapp_eigensolver -n 4096 --check``
(``--device cpu`` runs the plain versions of the kernels).
Distributed: ``torchrun --nproc-per-node 4 -m dlaf_tpu_torch.miniapps.miniapp_eigensolver
-n 4096 -b 512 --grid-rows 2 --grid-cols 2 --check`` (``--comm-backend gloo`` for several
ranks on one card).
"""
from __future__ import annotations

import functools

import torch

import dlaf_tpu_torch as dt
from dlaf_tpu_torch.matrix import generators as gen
from dlaf_tpu_torch.matrix.dist_matrix import DistMatrix
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
    dtype = options.dtype_of(args)
    with options.process_grid(args) as grid:
        device = options.device_of(args)
        a = options.load_input(args, lambda: gen.random_hermitian(
            torch.Generator(device=device).manual_seed(0), args.matrix_size, dtype), device)
        if grid is None:
            fn = functools.partial(dt.eigh, a, uplo=args.uplo, band=args.band_size)
            get = lambda out: out   # noqa: E731
        else:
            fn = functools.partial(dt.eigh_dist, DistMatrix.from_global(a, args.block_size, grid))
            get = lambda out: (out[0], out[1].to_global())   # noqa: E731

        def check(out):
            w, v = get(out)
            ok, orth, res = check_eigh(a, w, v, dtype)
            return ok, f"orth {orth:.2e} res {res:.2e}"

        out = options.run_timed(args, fn, 0, check_fn=check)
        if args.output_file:
            # reference --output-file contract (miniapp_eigensolver.cpp:169-180):
            # the input matrix under --input-dataset plus /evals and /evecs
            w, v = get(out)
            options.write_output(args, **{args.input_dataset: a, "/evals": w, "/evecs": v})


if __name__ == "__main__":
    main()
