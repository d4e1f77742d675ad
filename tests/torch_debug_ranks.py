"""Rank-side functions for tests/test_torch_debug.py.

``spawn_grid`` runs :func:`debug_cases` on every rank of a gloo grid on the
CPU. Like tests/torch_dist_ranks.py, this module imports torch, numpy and
the port only (no JAX), so that each rank starts quickly. It holds the
eager analogs of the reference's seeded cases (tests/test_collective_safety.py),
the case the reference misses (a collective in a loop's condition), the
planted divergences, and the sweep of every distributed entry point, each
run under ``dlaf_tpu_torch.debug``'s checker.
"""
import contextlib
import time

import numpy as np
import torch

import dlaf_tpu_torch as dt
from dlaf_tpu_torch import debug
from dlaf_tpu_torch.api import scalapack as sl
from dlaf_tpu_torch.comm import collectives as coll
from dlaf_tpu_torch.comm.mesh import COL_AXIS, ROW_AXIS
from dlaf_tpu_torch.matrix.dist_matrix import DistMatrix

from torch_dist_ranks import spd

N, NB = 64, 16             # the JAX fixtures' size (tests/test_collective_safety.py)
# plant_stall's late rank sleeps STALL_S against a checker timeout of
# STALL_TIMEOUT: the others give up at the step, then wait as long again
# for every rank's report, which the late rank sends before that
STALL_TIMEOUT, STALL_S = 2.0, 3.0
# the forced stalls: rank 1's timeout passes first, 0.5 s before the
# others'; rank 0 arrives FORCED_S late, after rank 1 stopped the call and
# 0.75 s before rank 1's wait for the reports (its timeout again) ends
FORCED_TIMEOUTS, FORCED_S = {1: 1.5}, 2.25


# --- the reference's seeded cases, as eager rank code -------------------------

def seeded_branch(grid):
    """A collective in one branch of a rank-dependent ``if`` (JAX: a psum in
    one branch of ``lax.cond``), then the collective every rank reaches."""
    x = torch.ones(4)
    if grid.coords[1] == 0:
        x = coll.allreduce_sum(x, COL_AXIS, grid)
    return coll.allreduce_sum(x, ROW_AXIS, grid)


def seeded_trip(grid):
    """A loop whose trip count depends on the rank, a collective in its
    body (JAX: a psum in a ``lax.while_loop`` body)."""
    x = torch.ones(4)
    for _ in range(1 + grid.coords[0]):
        x = coll.allreduce_sum(x, ROW_AXIS, grid)
    return x


def seeded_same(grid):
    """Both branches of a rank-dependent ``if`` issue the same collective."""
    x = torch.ones(4)
    if grid.rank % 2:
        return coll.allreduce_sum(x, ROW_AXIS, grid)
    return coll.allreduce_sum(2 * x, ROW_AXIS, grid)


def seeded_scan(grid):
    """Three ring shifts along the column axis, then a sum over the row
    axis (JAX: a ppermute in a length-3 ``lax.scan``, then a psum)."""
    x = torch.full((4,), float(grid.rank))
    for _ in range(3):
        x = coll.ring_shift(x, COL_AXIS, grid)
    return coll.allreduce_sum(x, ROW_AXIS, grid)


def seeded_loop_cond(grid):
    """A collective in a loop's condition, the trip count rank-dependent
    (JAX: a psum in a ``lax.while_loop`` condition, which its walker
    misses)."""
    it, limit = 0, 2 + 2 * grid.coords[0]
    while float(coll.allreduce_sum(torch.ones(1), COL_AXIS, grid)[0]) * it < limit:
        it += 1
    return it


SEEDED = {"branch": seeded_branch, "trip": seeded_trip, "same": seeded_same,
          "scan": seeded_scan, "loop_cond": seeded_loop_cond}


# --- planted divergences --------------------------------------------------------

def plant_shape(grid):
    """One grid column broadcasts a longer vector than the other expects."""
    return coll.bcast(torch.ones(4 + grid.coords[1]), 0, COL_AXIS, grid)


def plant_p2p_epoch(grid):
    """Rank 0 sends to rank 1 before a sum over the row axis, rank 1
    receives after it."""
    x = torch.ones(4)
    if grid.rank == 0:
        coll.sendrecv(x, 1, None, x.shape)
    if grid.rank == 1:
        x = coll.allreduce_sum(x, ROW_AXIS, grid)
        return coll.sendrecv(x, None, 0, x.shape)
    return coll.allreduce_sum(x, ROW_AXIS, grid)


def plant_p2p_shape(grid):
    """A square-grid shard swap in which rank 1 expects a longer tensor."""
    p, q = grid.coords
    if p == q:
        return None
    peer = grid.rank_of(q, p)
    return coll.sendrecv(torch.ones(4), peer, peer, (4 + (grid.rank == 1),))


def _cholesky(grid, device, seed=0):
    return dt.cholesky(DistMatrix.from_global(torch.from_numpy(spd(N, seed)), NB, grid,
                                              pad_identity=True, device=device))


def plant_extra_allreduce(grid, device):
    """cholesky, then one rank issues one sum more."""
    f = _cholesky(grid, device)
    if grid.rank == 1:
        coll.allreduce_sum(f.data[:1, :1], None, grid)
    return f


def plant_skipped_bcast(grid, device):
    """cholesky in which rank 1 skips its second panel broadcast."""
    real, calls = coll.bcast, [0]

    def skipping(x, owner, axis, g):
        calls[0] += 1
        return x if calls[0] == 2 else real(x, owner, axis, g)

    if grid.rank == 1:
        coll.bcast = skipping
    try:
        return _cholesky(grid, device)
    finally:
        coll.bcast = real


def plant_stall(grid, late_s=STALL_S):
    """Rank 0 reaches a sum over the grid later than the checker waits."""
    if grid.rank == 0:
        time.sleep(late_s)
    return coll.allreduce_sum(torch.ones(1), None, grid)


def plant_ring_stall(grid):
    """Rank 0 reaches a ring shift along a 1x4 row FORCED_S late: rank 3's
    send to it and rank 1's receive from it wait for its halves, rank 2
    (paired with ranks 1 and 3) waits at the end of the call."""
    if grid.rank == 0:
        time.sleep(FORCED_S)
    return coll.ring_shift(torch.ones(1), COL_AXIS, grid)


@contextlib.contextmanager
def checker_timeout(seconds):
    """The checker's timeout set to ``seconds`` in this process."""
    real, debug.TIMEOUT_S = debug.TIMEOUT_S, seconds
    try:
        yield
    finally:
        debug.TIMEOUT_S = real


PLANTS = {"shape": plant_shape, "p2p_epoch": plant_p2p_epoch, "p2p_shape": plant_p2p_shape,
          "extra_allreduce": plant_extra_allreduce, "skipped_bcast": plant_skipped_bcast}
PLANT_FINDINGS = {"shape": "shape-divergent", "p2p_epoch": "p2p-unpaired",
                  "p2p_shape": "shape-divergent", "extra_allreduce": "while-collective",
                  "skipped_bcast": "cond-divergent"}


# --- the sweep of the distributed entry points ------------------------------------

SWEEP_KEYS = ("cholesky-L", "cholesky-U", "cholesky_info", "cholesky_info-nonspd",
              "triangular_solver", "triangular_solver-RUC", "general_multiplication",
              "hermitian_multiplication", "triangular_multiplication",
              "generalized_to_standard_dist", "max_norm", "permute-rows", "permute-cols",
              "transpose", "symmetrize", "sub_matrix", "set_sub_matrix", "eigh_dist",
              "eigvalsh_dist", "eigh_dist-pipelined", "eigvalsh_dist-pipelined", "eigh_gen_dist")
SCALAPACK_KEYS = ("dlaf_pspotrf", "dlaf_pssyevd")


def sweep_keys(grid_size) -> tuple:
    """The keys of :func:`sweep` and :func:`scalapack_sweep` on a grid."""
    square = grid_size[0] == grid_size[1]
    return SWEEP_KEYS + (() if square else ("transpose-conj",)) + SCALAPACK_KEYS


def _hermitian(n, seed):
    r = np.random.default_rng(seed).uniform(-1, 1, (n, n))
    return (r + r.T) / 2


def sweep(grid, device) -> dict:
    """{key: a zero-argument call} for every distributed entry point on
    ``grid``, at n = 64, nb = 16 (f64)."""
    rng = np.random.default_rng(3)
    a, h = spd(N, 1), _hermitian(N, 2)
    b = rng.standard_normal((N, N))
    bad = a.copy()
    bad[33, 33] = -100.0        # a negative pivot in tile 2
    lfac = np.linalg.cholesky(spd(N, 4))
    square = grid.grid_size[0] == grid.grid_size[1]

    def dm(x, pad=False, nb=NB):
        return DistMatrix.from_global(torch.from_numpy(np.ascontiguousarray(x)), nb, grid,
                                      pad_identity=pad, device=device)

    def tuned(fn, **tune):
        def run():
            dt.set_tune_parameters(**tune)
            try:
                return fn()
            finally:
                dt.reset_tune_parameters()
        return run

    cases = {
        "cholesky-L": lambda: dt.cholesky(dm(a, True), uplo="L"),
        "cholesky-U": lambda: dt.cholesky(dm(a, True), uplo="U"),
        "cholesky_info": lambda: dt.cholesky_info(dm(a, True)),
        "cholesky_info-nonspd": lambda: dt.cholesky_info(dm(bad, True)),
        "triangular_solver": lambda: dt.triangular_solver(dm(np.tril(a), True), dm(b)),
        "triangular_solver-RUC": lambda: dt.triangular_solver(
            dm(np.triu(a), True), dm(b), side="R", uplo="U", trans="C"),
        "general_multiplication": lambda: dt.general_multiplication(dm(a), dm(b), dm(h),
                                                                    beta=0.5),
        "hermitian_multiplication": lambda: dt.hermitian_multiplication(dm(h), dm(b)),
        "triangular_multiplication": lambda: dt.triangular_multiplication(
            dm(np.tril(a)), dm(b), side="R", uplo="L"),
        "generalized_to_standard_dist": lambda: dt.generalized_to_standard_dist(
            dm(h), dm(lfac, True)),
        "max_norm": lambda: dt.max_norm(dm(b)),
        "permute-rows": lambda: dt.permute(dm(b), rng.permutation(N), axis=0),
        "permute-cols": lambda: dt.permute(dm(b), np.arange(N)[::-1].copy(), axis=1),
        "transpose": lambda: dm(b).transpose(),
        "symmetrize": lambda: dm(b).symmetrize(lower=False),
        "sub_matrix": lambda: dm(b).sub_matrix((1, 2), (45, 37)),
        "set_sub_matrix": lambda: dm(b).set_sub_matrix(dm(h[:45, :37]), (1, 2)),
        "eigh_dist": lambda: dt.eigh_dist(dm(h)),
        "eigvalsh_dist": lambda: dt.eigvalsh_dist(dm(h)),
        "eigh_dist-pipelined": tuned(lambda: dt.eigh_dist(dm(h)),
                                     band_to_tridiag_dist_mode="pipelined"),
        "eigvalsh_dist-pipelined": tuned(lambda: dt.eigvalsh_dist(dm(h)),
                                         band_to_tridiag_dist_mode="pipelined"),
        "eigh_gen_dist": lambda: dt.eigh_gen_dist(dm(h), dm(a, True)),
    }
    if not square:
        # the tile-slot all-to-all needs square blocks: nb 16 both ways (above)
        cases["transpose-conj"] = lambda: dm(b.astype(np.complex128) * (1 + 1j)).transpose()
    return cases


def scalapack_sweep(grid_size, device) -> dict:
    """{key: a zero-argument call} for ``dlaf_pspotrf`` and ``dlaf_pssyevd``
    on a context of ``grid_size`` over this process group (made here, out
    of the checked calls: it makes process subgroups)."""
    ctx = sl.dlaf_create_grid(*grid_size)
    desc = [1, 0, N, N, NB, NB, 0, 0, N]
    a32, h32 = spd(N, 5).astype(np.float32), _hermitian(N, 6).astype(np.float32)

    def entry(name, x):
        def run():
            dt.set_tune_parameters(eigensolver_min_band=8, default_block_size=NB)
            try:
                return getattr(sl, name)("L", N, x, 1, 1, desc, ctx=ctx, device=device)
            finally:
                dt.reset_tune_parameters()
        return run

    return {"dlaf_pspotrf": entry("dlaf_pspotrf", a32), "dlaf_pssyevd": entry("dlaf_pssyevd", h32)}


def _checked(fn, *args) -> dict:
    """``fn(*args)`` under the checker: its findings, this rank's counts of
    group (non-local), point-to-point and local calls, and the seconds."""
    t0 = time.perf_counter()
    with debug.record_schedule(check=True) as rec:
        fn(*args)
    return {"findings": rec.findings, "seconds": time.perf_counter() - t0,
            "group": sum(1 for op in rec.ops if op.prim != "sendrecv" and not op.local),
            "p2p": sum(1 for op in rec.ops if op.prim == "sendrecv" and not op.local),
            "local": sum(1 for op in rec.ops if op.local)}


def debug_cases(extra_grids, grid, device) -> dict:
    """Everything on this rank: the seeded cases and plants (2x2 only), the
    sweep on ``grid`` and on each of ``extra_grids`` made over the same
    ranks (e.g. 1x4 on the ranks of 2x2), the ScaLAPACK entries on each,
    the schedules of the seeded scan and of cholesky, and
    ``assert_same_schedule`` of cholesky over two SPD inputs. The stalls
    run with the timeout cut: ``stall`` at STALL_TIMEOUT on every rank, the
    forced ones (2x2, and 1x4 over the same ranks) with rank 1's passing
    first."""
    out = {"rank": grid.rank, "seeded": {}, "plants": {}, "sweep": {}}
    grids = [grid] + [dt.Grid(gs) for gs in extra_grids]
    if grid.grid_size == (2, 2):
        for name, fn in SEEDED.items():
            out["seeded"][name] = _checked(fn, grid)
        out["scan_prims"] = [op.prim for op in debug.collective_schedule(seeded_scan, grid)]
        for name, fn in PLANTS.items():
            args = (grid, device) if name in ("extra_allreduce", "skipped_bcast") else (grid,)
            out["plants"][name] = _checked(fn, *args)
        with checker_timeout(STALL_TIMEOUT):
            out["stall"] = _checked(plant_stall, grid)
        with checker_timeout(FORCED_TIMEOUTS.get(grid.rank, STALL_TIMEOUT)):
            out["forced_stall"] = _checked(plant_stall, grid, FORCED_S)
            row = next(g for g in grids if g.grid_size == (1, 4))
            out["forced_ring_stall"] = _checked(plant_ring_stall, row)
    for g in grids:
        tag = f"{g.grid_size[0]}x{g.grid_size[1]}"
        cases = {**sweep(g, device), **scalapack_sweep(g.grid_size, device)}
        for key, fn in cases.items():
            out["sweep"][f"{tag}/{key}"] = _checked(fn)
    out["same_inputs"] = debug.assert_same_schedule(
        lambda s: _cholesky(grid, device, s), [(0,), (7,)])
    out["schedule"] = [(op.prim, op.axes, op.local) for op in debug.collective_schedule(
        _cholesky, grid, device)]
    return out
