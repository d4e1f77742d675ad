"""Reduction-to-band miniapp (reference ``miniapp/miniapp_reduction_to_band.cpp``).

PyTorch counterpart of :mod:`dlaf_tpu.miniapps.miniapp_reduction_to_band`:
stage 1 of the eigensolver on a random hermitian A, band ``--band-size``
(default min(block size, 128)); local ``reduction_to_band``, or on a grid
(one process per rank) ``reduction_to_band_dist`` on a DistMatrix whose
block size is the band, as the JAX miniapp distributes it; GFlop/s with
add = mul = 2 n^3 / 3, and with ``--check`` the eigenvalues of the band
matrix against those of A, max|ev - ref| / max(1, max|ref|) <= 500 n eps,
both in the working precision on the run's device. ``--input-file`` reads
A, ``--output-file`` writes A and /band (``matrix/io.py``).

Run: ``python -m dlaf_tpu_torch.miniapps.miniapp_reduction_to_band -n 8192 --band-size 128 --check``
(distributed: under ``torchrun --nproc-per-node P*Q`` with ``--grid-rows P --grid-cols Q``)
"""
from __future__ import annotations

import functools

import torch

from dlaf_tpu_torch.algos.eigensolver.dist_red2band import reduction_to_band_dist
from dlaf_tpu_torch.algos.eigensolver.red2band import extract_band, reduction_to_band
from dlaf_tpu_torch.matrix import generators as gen
from dlaf_tpu_torch.matrix.dist_matrix import DistMatrix
from dlaf_tpu_torch.types import eps, total_ops

from . import options


def main(argv=None):
    args = options.parser("miniapp_reduction_to_band").parse_args(argv)
    band = args.band_size or min(args.block_size, 128)
    dtype = options.dtype_of(args)
    with options.process_grid(args) as grid:
        device = options.device_of(args)
        a = options.load_input(args, lambda: gen.random_hermitian(
            torch.Generator(device=device).manual_seed(0), args.matrix_size, dtype), device)
        n = args.matrix_size
        if n % band:
            raise SystemExit("matrix-size must be a multiple of band-size")
        if grid is None:
            fn = functools.partial(reduction_to_band, a, band)
            get = lambda out: out[0]   # noqa: E731
        else:
            dm = DistMatrix.from_global(a, band, grid)
            fn = functools.partial(reduction_to_band_dist, dm)
            get = lambda out: out[0].to_global()   # noqa: E731
        flops = total_ops(dtype, 2 * n**3 / 3, 2 * n**3 / 3)

        def check(out):
            ev = torch.linalg.eigvalsh(extract_band(get(out), band))
            ref = torch.linalg.eigvalsh(a)
            err = float((ev - ref).abs().max()) / max(float(ref.abs().max()), 1.0)
            return err <= 500 * n * eps(dtype), f"eig err {err:.2e}"

        out = options.run_timed(args, fn, flops, check_fn=check)
        if args.output_file:
            # reference contract (miniapp_reduction_to_band.cpp:184-185): the
            # input matrix plus the reduced (band + reflectors) matrix
            options.write_output(args, **{args.input_dataset: a, "/band": get(out)})


if __name__ == "__main__":
    main()
