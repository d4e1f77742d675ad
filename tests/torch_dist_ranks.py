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
from dlaf_tpu_torch.comm import collectives as coll
from dlaf_tpu_torch.comm import panel
from dlaf_tpu_torch.comm.mesh import COL_AXIS, ROW_AXIS
from dlaf_tpu_torch.matrix.dist_matrix import DistMatrix
from dlaf_tpu_torch.miniapps import (miniapp_band_to_tridiag, miniapp_bt_band_to_tridiag,
                                     miniapp_bt_reduction_to_band, miniapp_cholesky,
                                     miniapp_eigensolver, miniapp_gen_eigensolver,
                                     miniapp_gen_to_std, miniapp_reduction_to_band,
                                     miniapp_triangular_multiplication,
                                     miniapp_triangular_solver, miniapp_tridiag_solver)

MINIAPPS = {"cholesky": miniapp_cholesky, "triangular_solver": miniapp_triangular_solver,
            "triangular_multiplication": miniapp_triangular_multiplication,
            "gen_to_std": miniapp_gen_to_std, "eigensolver": miniapp_eigensolver,
            "gen_eigensolver": miniapp_gen_eigensolver,
            "reduction_to_band": miniapp_reduction_to_band,
            "band_to_tridiag": miniapp_band_to_tridiag,
            "tridiag_solver": miniapp_tridiag_solver,
            "bt_band_to_tridiag": miniapp_bt_band_to_tridiag,
            "bt_reduction_to_band": miniapp_bt_reduction_to_band}


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


def miniapp(argv, grid, device, name="cholesky"):
    """The miniapp ``name`` (default the Cholesky one) on this rank;
    returns what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        MINIAPPS[name].main(argv)
    return buf.getvalue()


def miniapps(runs, grid, device):
    """Each ``(name, argv)`` miniapp in turn on this rank; returns what each
    printed."""
    return [miniapp(argv, grid, device, name) for name, argv in runs]


def _blas_case(kind, arrays, kw, grid, device):
    """One case of :func:`dist_blas_cases`: the gathered result, or for
    ``ring`` this rank's received value."""
    nb = kw.get("nb")

    def dm(x, pad=False):
        return DistMatrix.from_global(torch.from_numpy(x), nb, grid, pad_identity=pad,
                                      device=device)

    if kind == "transpose":
        t = dm(arrays[0]).transpose(conj=kw["conj"])
        return t.to_global().numpy(), t.dist.size, t.dist.block_size, t.local_shape
    if kind == "symmetrize":
        return dm(arrays[0]).symmetrize(lower=kw["lower"]).to_global().numpy()
    if kind == "ring":
        p, q = grid.coords
        x = torch.tensor([float(p * grid.grid_size[1] + q)], device=device)
        return float(coll.ring_shift(x, kw["axis"], grid, kw["shift"])[0])
    if kind == "trsm":
        a, b = arrays
        return dt.triangular_solver(dm(a, True), dm(b), side=kw["side"], uplo=kw["uplo"],
                                    trans=kw["trans"], diag=kw["diag"],
                                    alpha=kw["alpha"]).to_global().numpy()
    if kind == "gemm":
        a, b, c = arrays
        return dt.general_multiplication(dm(a), dm(b), dm(c), alpha=kw["alpha"],
                                         beta=kw["beta"]).to_global().numpy()
    if kind == "hemm":
        a, b = arrays
        return dt.hermitian_multiplication(dm(a), dm(b), uplo=kw["uplo"],
                                           alpha=kw["alpha"]).to_global().numpy()
    if kind == "trmm":
        a, b = arrays
        return dt.triangular_multiplication(dm(a), dm(b), side=kw["side"], uplo=kw["uplo"],
                                            diag=kw["diag"],
                                            alpha=kw["alpha"]).to_global().numpy()
    if kind == "gen_to_std":
        a, l = arrays
        return dt.generalized_to_standard_dist(dm(a), dm(l, True),
                                               uplo=kw["uplo"]).to_global().numpy()
    if kind == "norm":
        return float(dt.max_norm(dm(arrays[0]), uplo=kw["uplo"]))
    if kind == "permute":
        return dt.permute(dm(arrays[0]), arrays[1], axis=kw["axis"]).to_global().numpy()
    if kind == "multichip":
        a, b = arrays
        da, db = dm(a, True), dm(b)
        f = dt.cholesky(da)
        x = dt.triangular_solver(f, db, uplo="L", trans="N")
        c = dt.general_multiplication(da, db)
        return f.to_global().numpy(), x.to_global().numpy(), c.to_global().numpy()
    raise ValueError(f"unknown case kind {kind!r}")


def dist_blas_cases(cases, grid, device):
    """Each ``(key, kind, arrays, kw)`` on the grid: {key: result} on rank 0
    (None elsewhere), but ``ring`` cases on every rank, whose result is
    what that rank received."""
    out = {}
    for key, kind, arrays, kw in cases:
        res = _blas_case(kind, arrays, kw, grid, device)
        out[key] = res if grid.rank == 0 or kind == "ring" else None
    return out


def spd(n, seed, dtype=np.float64):
    """Hermitian positive definite test input, made with numpy."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(-1, 1, (n, n))
    if np.dtype(dtype).kind == "c":
        r = r + 1j * rng.uniform(-1, 1, (n, n))
    return ((r + r.conj().T) / 2 + n * np.eye(n)).astype(dtype)


def _eig_case(kind, arrays, kw, grid, device):
    """One case of :func:`dist_eig_cases`, run on every rank; the gathered
    result."""
    from dlaf_tpu_torch.algos.eigensolver import dist_stage23 as s23
    from dlaf_tpu_torch.algos.eigensolver.dist_driver import _eigh_dist_gathered
    from dlaf_tpu_torch.algos.eigensolver.dist_red2band import reduction_to_band_dist

    nb = kw.get("nb")

    def dm(x, pad=False):
        return DistMatrix.from_global(torch.from_numpy(x), nb, grid, pad_identity=pad,
                                      device=device)

    if kind == "red2band":
        packed, taus = reduction_to_band_dist(dm(arrays[0]), kw["band"])
        return np.tril(packed.to_global().numpy()), taus.numpy()
    if kind == "eigh":
        w, v = dt.eigh_dist(dm(arrays[0]))
        return w.numpy(), v.to_global().numpy()
    if kind == "evals":
        return dt.eigvalsh_dist(dm(arrays[0])).numpy()
    if kind == "gen":
        w, x = dt.eigh_gen_dist(dm(arrays[0]), dm(arrays[1], True))
        return w.numpy(), x.to_global().numpy()
    if kind == "gathered":
        w, v = _eigh_dist_gathered(dm(arrays[0]), dt.get_tune_parameters().laed4_max_iter)
        return w.numpy(), v.to_global().numpy()
    if kind == "stage2":
        # the replicated stage 2 on the strips of stage 1's band: d and e
        # of this rank (each rank chases the same band)
        packed, _ = reduction_to_band_dist(dm(arrays[0]), kw["band"])
        strips = s23.strips_from_packed_dist(packed, kw["band"])
        d, e, vs, taus = s23.band_to_tridiag_dist(strips, packed.dist.padded_size[0],
                                                  kw["band"], grid)
        return d.numpy(), e.numpy(), vs.shape
    if kind == "multichip":
        spd_a, h = arrays
        w, x = dt.eigh_gen_dist(dm(h), dm(spd_a, True))
        dt.set_tune_parameters(band_to_tridiag_dist_mode="pipelined")
        wp, vp = dt.eigh_dist(dm(h))
        return w.numpy(), x.to_global().numpy(), wp.numpy(), vp.to_global().numpy()
    raise ValueError(f"unknown case kind {kind!r}")


def dist_eig_cases(cases, grid, device):
    """Each ``(key, kind, arrays, kw)`` on the grid, with the tune
    parameters in ``kw["tune"]`` for that case: {key: result} on rank 0
    (None elsewhere), but ``stage2`` cases on every rank."""
    out = {}
    for key, kind, arrays, kw in cases:
        dt.set_tune_parameters(**kw.get("tune", {}))
        try:
            res = _eig_case(kind, arrays, kw, grid, device)
        finally:
            dt.reset_tune_parameters()
        out[key] = res if grid.rank == 0 or kind == "stage2" else None
    return out


def eig_cases_and_miniapps(cases, runs, grid, device):
    """:func:`dist_eig_cases`, then :func:`miniapps` under the key "miniapps"."""
    out = dist_eig_cases(cases, grid, device)
    out["miniapps"] = miniapps(runs, grid, device)
    return out


def tridiag_cases(cases, grid, device):
    """Each ``(key, kind, arrays, kw)``: ``dc`` runs tridiag_eigh_dist on
    (d, e) and returns (lam, the gathered q); ``pipelined`` runs the
    compute-distributed stage 2 on strips and returns (d, e, the
    sweep-sharded record gathered in flat order). Rank 0's results."""
    from dlaf_tpu_torch.algos.eigensolver import dist_stage23 as s23
    from dlaf_tpu_torch.algos.eigensolver.tridiag_dc_dist import rank_of_flat, tridiag_eigh_dist

    out = {}
    for key, kind, arrays, kw in cases:
        if kind == "dc":
            lam, q, m = tridiag_eigh_dist(torch.from_numpy(arrays[0]),
                                          torch.from_numpy(arrays[1]), grid)
            res = lam.numpy(), s23.gather_columns(q, grid).numpy(), m
        else:
            d, e, vs, taus = s23.band_to_tridiag_dist_pipelined(
                torch.from_numpy(arrays[0]), kw["n"], kw["b"], grid)
            order = [rank_of_flat(grid, k) for k in range(grid.size)]

            def sweeps(x):      # the sweep chunks in flat order
                return coll.allgather_tiles(x, None, grid)[order].flatten(0, 1).numpy()

            res = d.numpy(), e.numpy(), sweeps(vs), sweeps(taus)
        out[key] = res if grid.rank == 0 else None
    return out


def _surface_case(kind, arrays, kw, grid, device):
    """One case of :func:`surface_cases`."""
    from dlaf_tpu_torch.matrix import io as mio
    from dlaf_tpu_torch.matrix import printing

    nb = kw.get("nb")

    def dm(x, pad=False):
        return DistMatrix.from_global(torch.from_numpy(x), nb, grid, pad_identity=pad,
                                      device=device)

    if kind == "from_callback":
        a = arrays[0]
        r = DistMatrix.from_callback(lambda idx: a[idx], a.shape, nb, grid, a.dtype,
                                     pad_identity=kw["pad"], device=device)
        ref = dm(a, kw["pad"])
        return {"shard": r.data.numpy(), "from_global_equal": torch.equal(r.data, ref.data)}
    if kind == "retiled":
        m = dm(arrays[0])
        r = m.retiled(kw["tile"])
        return {"shard": r.data.numpy(), "tile": r.dist.tile, "same": r.data is m.data,
                "size": r.dist.size}
    if kind == "sub_matrix":
        r = dm(arrays[0]).sub_matrix(kw["offset"], kw["size"], pad_identity=kw["pad"])
        return {"shard": r.data.numpy(), "global": r.to_global().numpy(),
                "size": r.dist.size}
    if kind == "set_sub_matrix":
        r = dm(arrays[0]).set_sub_matrix(dm(arrays[1]), kw["offset"])
        return {"shard": r.data.numpy(), "global": r.to_global().numpy()}
    if kind == "read_dist":
        r = mio.MatrixFile(kw["path"]).read_dist(kw["name"], nb, grid, device=device)
        return {"shard": r.data.numpy(), "global": r.to_global().numpy()}
    if kind == "print":
        buf = io.StringIO()
        printing.print_numpy(dm(arrays[0]), "m", file=buf)
        printing.print_csv(dm(arrays[0]), file=buf)
        return buf.getvalue()
    if kind == "multihost":
        from dlaf_tpu_torch.comm.mesh import Grid
        g = Grid.multihost(kw["intra"], host=kw["hosts"][grid.rank])
        # a collective over each axis group checks that the subgroups work
        s = coll.allreduce_sum(torch.tensor([float(grid.rank)]), ROW_AXIS, g)
        return {"grid_size": g.grid_size, "coords": g.coords,
                "table": [[g.rank_of(p, q) for q in range(g.grid_size[1])]
                          for p in range(g.grid_size[0])],
                "row_sum": float(s[0])}
    if kind == "communication":
        from dlaf_tpu_torch.miniapps import miniapp_communication
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            miniapp_communication.main(kw["argv"])
        return buf.getvalue()
    raise ValueError(kind)


def surface_cases(cases, grid, device):
    """{key: this rank's result} of each ``(key, kind, arrays, kw)``, and
    this rank's coordinates under ``"coords"``."""
    out = {"coords": grid.coords, "rank": grid.rank}
    for key, kind, arrays, kw in cases:
        out[key] = _surface_case(kind, arrays, kw, grid, device)
    return out


def scalapack_cases(cases, grid, device):
    """Each ``(key, grid_size, entry, args, kw)``: the ScaLAPACK entry
    ``entry`` of ``dlaf_tpu_torch.api.scalapack`` called with ``args`` and
    ``kw`` on a new context of ``grid_size`` over this process group (the
    spawned ``grid`` only brings the ranks up), with the tune parameters
    of the JAX tests; returns {key: result} on every rank."""
    from dlaf_tpu_torch.api import scalapack as sl
    out = {}
    dt.set_tune_parameters(eigensolver_min_band=8, default_block_size=16)
    try:
        for key, gs, entry, args, kw in cases:
            ctx = sl.dlaf_create_grid(*gs)
            try:
                uplo, n, rest = args[0], args[1], args[2:]
                out[key] = getattr(sl, entry)(uplo, n, *rest, ctx=ctx, device=device, **kw)
            finally:
                sl.dlaf_free_grid(ctx)
    finally:
        dt.reset_tune_parameters()
    return out
