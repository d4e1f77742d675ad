"""Back-transformation (reduction to band) miniapp
(reference ``miniapp/miniapp_bt_reduction_to_band.cpp``).

PyTorch counterpart of :mod:`dlaf_tpu.miniapps.miniapp_bt_reduction_to_band`:
stage 1 of a random hermitian A once; each run applies its reflectors to
a random n x n E; GFlop/s with add = mul = 2 n^3. Local:
``reduction_to_band`` and ``bt_reduction_to_band``. On a grid (one process
per rank): ``reduction_to_band_dist`` on a DistMatrix whose block size is
the band (as the JAX miniapp distributes it) and
``bt_reduction_to_band_dist`` on each rank's columns of E, zero-padded to
the padded size. With ``--check``, the commutation A (Q E) = Q (B E), B
the band form: max|lhs - rhs| <= 200 n eps max(1, max|A|) max(1, max|E|)
(the JAX miniapp checks its local branch only; here the distributed one
too, on the gathered columns). Every product is a full-precision one
(TF32 is off, ``ops/core.py``), as the JAX miniapp pins its check's
products to f32.

Run: ``python -m dlaf_tpu_torch.miniapps.miniapp_bt_reduction_to_band -n 8192 --band-size 128 --check``
(distributed: under ``torchrun --nproc-per-node P*Q`` with ``--grid-rows P --grid-cols Q``)
"""
from __future__ import annotations

import functools

import torch

from dlaf_tpu_torch.algos.eigensolver.bt import bt_reduction_to_band
from dlaf_tpu_torch.comm import collectives as coll
from dlaf_tpu_torch.dist import gather_from_shards
from dlaf_tpu_torch.algos.eigensolver.dist_red2band import reduction_to_band_dist
from dlaf_tpu_torch.algos.eigensolver.dist_stage23 import (bt_reduction_to_band_dist,
                                                           column_shard, gather_columns)
from dlaf_tpu_torch.algos.eigensolver.red2band import extract_band, reduction_to_band
from dlaf_tpu_torch.matrix import generators as gen
from dlaf_tpu_torch.matrix.dist_matrix import DistMatrix
from dlaf_tpu_torch.types import eps, total_ops

from . import options


def padded_global(dm: DistMatrix) -> torch.Tensor:
    """The whole padded (pm, pn) matrix of ``dm`` on every rank (every
    rank calls it); the padding rows and columns of a reduction to band
    carry its reflectors' mixing."""
    grid = dm.grid
    shards = coll.allgather_tiles(dm.data, None, grid)
    P, Q = grid.grid_size
    order = [grid.rank_of(p, q) for p in range(P) for q in range(Q)]
    return gather_from_shards(shards[order].reshape(P, Q, *dm.data.shape), dm.dist)


def main(argv=None):
    args = options.parser("miniapp_bt_reduction_to_band").parse_args(argv)
    n = args.matrix_size
    band = args.band_size or min(args.block_size, 128)
    if n % band:
        raise SystemExit("matrix-size must be a multiple of band-size")
    dtype = options.dtype_of(args)
    with options.process_grid(args) as grid:
        device = options.device_of(args)
        a = gen.random_hermitian(torch.Generator(device=device).manual_seed(0), n, dtype)
        emat = gen.random_general(torch.Generator(device=device).manual_seed(1), (n, n), dtype)
        afull = torch.tril(a) + torch.tril(a, -1).mH
        if grid is None:
            packed, taus = reduction_to_band(a, band)
            bmat = extract_band(packed, band)
            apply = functools.partial(bt_reduction_to_band, a_packed=packed, taus=taus, band=band)
            get = lambda x: x   # noqa: E731
        else:
            # the padded problem: A and E zero past n, Q of the padded A
            dpacked, taus = reduction_to_band_dist(DistMatrix.from_global(a, band, grid))
            pm = dpacked.dist.padded_size[0]
            bmat = extract_band(padded_global(dpacked)[:pm, :pm], band)
            afull = torch.nn.functional.pad(afull, (0, pm - n, 0, pm - n))
            emat = torch.nn.functional.pad(emat, (0, pm - n, 0, pm - n))

            def apply(x):
                return bt_reduction_to_band_dist(column_shard(x, grid), dpacked, taus)

            get = lambda x: gather_columns(x, grid)[:, :pm]   # noqa: E731
        fn = functools.partial(apply, emat)

        def check(out):
            # Q satisfies A = Q B Q^H (B the band form), hence A (Q E) = Q (B E)
            lhs = afull @ get(out)
            rhs = get(apply(bmat @ emat))
            scale = max(float(a.abs().max()), 1.0) * max(float(emat.abs().max()), 1.0)
            err = float((lhs - rhs).abs().max())
            tol = 200 * n * eps(dtype) * scale
            return err <= tol, f"commutation err {err:.2e} tol {tol:.2e}"

        flops = total_ops(dtype, 2 * n**3, 2 * n**3)   # ~4 n^2 nev with nev = n
        options.run_timed(args, fn, flops, check_fn=check)


if __name__ == "__main__":
    main()
