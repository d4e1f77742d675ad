"""Rank-side functions for the port's distributed tests.

``dlaf_tpu_torch.comm.launch.spawn_grid`` runs these in spawned processes,
which import them by module path: this module imports torch, numpy and the
port only (no JAX), so that each rank starts quickly. Inputs arrive as
numpy arrays, results go back as numpy arrays.
"""
import contextlib
import io

import numpy as np
import torch

import dlaf_tpu_torch as dt
from dlaf_tpu_torch.algos import cholesky as chol
from dlaf_tpu_torch.comm import panel
from dlaf_tpu_torch.comm.mesh import COL_AXIS, ROW_AXIS
from dlaf_tpu_torch.matrix.dist_matrix import DistMatrix
from dlaf_tpu_torch.miniapps import miniapp_cholesky


def cholesky_cases(cases, grid, device):
    """Factor each case ``(key, a, nb, uplo, route, panel_width, info)`` on
    the grid. Returns ``(factors, k6_calls)``: on rank 0 {key: the gathered
    factor, or (factor, info) for an ``info`` case} (None elsewhere), and
    on every rank {key: the number of K6 calls this rank made}."""
    real = chol.ksub_matmul_masked
    calls = [0]

    def counted(*args, **kw):
        calls[0] += 1
        return real(*args, **kw)

    factors, k6 = {}, {}
    chol.ksub_matmul_masked = counted
    try:
        for key, a, nb, uplo, route, panel_width, info in cases:
            dt.set_tune_parameters(potrf_trailing_kernel=route,
                                   potrf_dist_panel_width=panel_width)
            dm = DistMatrix.from_global(torch.from_numpy(a), nb, grid, pad_identity=True,
                                        device=device)
            calls[0] = 0
            if info:
                f, inf = chol.cholesky_info(dm)
                res = (f.to_global().numpy(), int(inf))
            else:
                res = chol.cholesky(dm, uplo=uplo).to_global().numpy()
            k6[key] = calls[0]
            factors[key] = res if grid.rank == 0 else None
    finally:
        chol.ksub_matmul_masked = real
        dt.reset_tune_parameters()
    return factors, k6


def dist_matrix_cases(cases, grid, device):
    """For each ``(key, a, nb, pad_identity)``: this rank's local shard,
    the gathered matrix, the diagonal, the shard's first column (row) slab
    gathered tile-major over the row (column) axis, the global column
    panel at column nb + 3, 5 wide, and the first local row slab of grid
    row P - 1 broadcast down each grid column. Also this rank's grid
    coordinates."""
    out = {"coords": grid.coords, "rank": grid.rank}
    for key, a, nb, pad in cases:
        dm = DistMatrix.from_global(torch.from_numpy(a), nb, grid, pad_identity=pad,
                                    device=device)
        x = dm.data
        out[key] = {"shard": x.numpy(), "global": dm.to_global().numpy(),
                    "diag": dm.diagonal().numpy(), "local_shape": dm.local_shape,
                    "tiles_r": panel.all_tiles(x[:, :nb], ROW_AXIS, nb, grid).numpy(),
                    "tiles_c": panel.all_tiles(x[:nb, :], COL_AXIS, nb, grid).numpy(),
                    "col_panel": panel.gather_col_panel(x, nb + 3, 5, nb, x.shape[0] // nb,
                                                        grid).numpy(),
                    "row_slab": panel.bcast_row_slab(x, 0, grid.grid_size[0] - 1, nb,
                                                     grid).numpy()}
    return out


def miniapp(argv, grid, device):
    """The Cholesky miniapp on this rank; returns what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        miniapp_cholesky.main(argv)
    return buf.getvalue()


def spd(n, seed, dtype=np.float64):
    """Hermitian positive definite test input, made with numpy."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(-1, 1, (n, n))
    if np.dtype(dtype).kind == "c":
        r = r + 1j * rng.uniform(-1, 1, (n, n))
    return ((r + r.conj().T) / 2 + n * np.eye(n)).astype(dtype)
