"""The port's distributed Cholesky against the JAX package's.

The same numpy SPD input goes through ``dlaf_tpu.algos.cholesky`` on the
CPU device mesh (as tests/test_dist_cholesky.py runs it) and through
``dlaf_tpu_torch.algos.cholesky`` on process grids: the 1x1 grid in this
process (it needs no process group), and 2x2, 2x3 and 2x4 grids of gloo
ranks spawned by ``spawn_grid`` (2x4 is the chol case of
MULTICHIP_r05.json, n = 64, nb = 8). Each grid's cases run in one spawn,
in a background thread while the JAX references compile, and every case
is its own assertion.

Cases: L and U; n in {7, 64, 100, 200, 304} with nb 16 or 32 (the tail
cases of tests/test_dist_cholesky.py); f32, f64 and one complex64; both
trailing routes of the port (``"kernel"`` runs K6's plain version here,
``"torch"`` matmul + where); one L case with ``potrf_dist_panel_width=16``
where JAX takes its bucketed path and the port its unrolled loop; and
``cholesky_info`` on a planted non-positive pivot.
"""
import concurrent.futures
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dlaf_tpu
from dlaf_tpu.algos import cholesky as jax_chol
from dlaf_tpu.comm.mesh import Grid as JaxGrid
from dlaf_tpu.matrix.dist_matrix import DistMatrix as JaxDistMatrix
from dlaf_tpu_torch.comm.launch import spawn_grid
from dlaf_tpu_torch.comm.mesh import Grid

import torch_dist_ranks as ranks
from conftest import tol

F32, F64, C64 = np.float32, np.float64, np.complex64
DEFAULT_PW = 2048
# (grid, n, nb, dtype, uplo, panel width)
CASES = [
    ((1, 1), 64, 16, F32, "L", DEFAULT_PW), ((1, 1), 64, 16, F32, "U", DEFAULT_PW),
    ((1, 1), 7, 16, F32, "L", DEFAULT_PW),
    ((1, 1), 544, 16, F64, "L", 16),          # 34 panels: JAX's bucketed path
    ((2, 2), 64, 16, F32, "L", DEFAULT_PW), ((2, 2), 64, 16, F32, "U", DEFAULT_PW),
    ((2, 2), 100, 16, F32, "L", DEFAULT_PW), ((2, 2), 100, 16, F32, "U", DEFAULT_PW),
    ((2, 2), 304, 16, F64, "L", DEFAULT_PW), ((2, 2), 304, 16, F64, "U", DEFAULT_PW),
    ((2, 2), 100, 16, C64, "L", DEFAULT_PW),
    ((2, 3), 200, 32, F32, "L", DEFAULT_PW), ((2, 3), 200, 32, F32, "U", DEFAULT_PW),
    ((2, 3), 7, 16, F32, "L", DEFAULT_PW), ((2, 3), 7, 16, F32, "U", DEFAULT_PW),
    ((2, 3), 64, 16, F64, "L", DEFAULT_PW),
    ((2, 4), 64, 8, F32, "L", DEFAULT_PW), ((2, 4), 64, 8, F32, "U", DEFAULT_PW),
]
GRIDS = sorted({c[0] for c in CASES})
ROUTES = ("kernel", "torch")
INFO_GRID, INFO_N, INFO_NB, INFO_BAD = (2, 2), 64, 16, 33


def _key(case):
    gs, n, nb, dtype, uplo, pw = case
    return f"{gs[0]}x{gs[1]}-n{n}-nb{nb}-{np.dtype(dtype).name}-{uplo}" + \
        ("" if pw == DEFAULT_PW else f"-pw{pw}")


def _input(case):
    gs, n, nb, dtype, uplo, pw = case
    return ranks.spd(n, n + 7 * gs[1], dtype)


def _info_input():
    a = ranks.spd(INFO_N, 3, F32)
    a[INFO_BAD, INFO_BAD] = -100.0     # inside tile 2 (rows 32..47)
    return a


def _port_cases(gs):
    cases = [(f"{_key(c)}/{route}", _input(c), c[2], c[4], route, c[5], False)
             for c in CASES if c[0] == gs for route in ROUTES]
    if gs == INFO_GRID:
        cases.append(("info", _info_input(), INFO_NB, "L", "kernel", DEFAULT_PW, True))
    return cases


def _run_port():
    """{grid: (factors of rank 0, [K6 calls per rank])}."""
    out = {}
    for gs in GRIDS:
        cases = _port_cases(gs)
        if gs == (1, 1):
            factors, k6 = ranks.cholesky_cases(cases, Grid(gs), torch.device("cpu"))
            out[gs] = (factors, [k6])
            continue
        res = spawn_grid(functools.partial(ranks.cholesky_cases, cases), gs,
                         backend="gloo", device="cpu", timeout=600)
        out[gs] = (res[0][0], [k6 for _, k6 in res])
    return out


def _jax_factor(case, a, info=False):
    gs, n, nb, dtype, uplo, pw = case
    old = dlaf_tpu.get_tune_parameters().potrf_dist_panel_width
    dlaf_tpu.set_tune_parameters(potrf_dist_panel_width=pw)
    try:
        dm = JaxDistMatrix.from_global(jnp.asarray(a), nb, JaxGrid(gs), pad_identity=True)
        if info:
            f, inf = jax_chol.cholesky_info(dm)
            return np.asarray(f.to_global()), int(inf)
        return np.asarray(jax_chol.cholesky(dm, uplo=uplo).to_global())
    finally:
        dlaf_tpu.set_tune_parameters(potrf_dist_panel_width=old)


@pytest.fixture(scope="module")
def results():
    """The port's factors (spawned in a background thread) and the JAX
    references; records which JAX cases traced the bucketed path."""
    bucketed = []
    real = jax_chol._dist_potrf_shardfn

    def traced(*a, **k):
        bucketed.append(True)
        return real(*a, **k)

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(_run_port)
        jax_refs = {}
        for case in CASES:
            bucketed.clear()
            jax_chol._dist_potrf_shardfn = traced
            try:
                jax_refs[_key(case)] = (_jax_factor(case, _input(case)), bool(bucketed))
            finally:
                jax_chol._dist_potrf_shardfn = real
        info_case = (INFO_GRID, INFO_N, INFO_NB, F32, "L", DEFAULT_PW)
        jax_refs["info"] = _jax_factor(info_case, _info_input(), info=True)
        return port.result(), jax_refs


def _tri(f, uplo):
    return np.tril(f) if uplo == "L" else np.triu(f)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", CASES, ids=[_key(c) for c in CASES])
def test_factor_matches_jax(results, case, route):
    port, jax_refs = results
    gs, n, nb, dtype, uplo, pw = case
    got = _tri(port[gs][0][f"{_key(case)}/{route}"], uplo)
    want = _tri(jax_refs[_key(case)][0], uplo)
    a = _input(case)
    err = np.abs(got - want).max()
    assert err <= tol(dtype, n, 50) * np.abs(want).max(), (err, case, route)
    rec = got @ got.conj().T if uplo == "L" else got.conj().T @ got
    res = np.abs(rec - a).max() / max(n, 1)
    assert res <= tol(dtype, n, 50), (res, case, route)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", CASES, ids=[_key(c) for c in CASES])
def test_other_triangle_kept(results, case, route):
    """The strict other triangle keeps the input bit for bit."""
    port, _ = results
    gs, n, nb, dtype, uplo, pw = case
    got = port[gs][0][f"{_key(case)}/{route}"]
    a = _input(case)
    other = (lambda x: np.triu(x, 1)) if uplo == "L" else (lambda x: np.tril(x, -1))
    np.testing.assert_array_equal(other(got), other(a))


@pytest.mark.parametrize("gs", GRIDS, ids=[f"{g[0]}x{g[1]}" for g in GRIDS])
def test_k6_on_every_rank(results, gs):
    """The kernel route reaches K6 on every rank wherever an f32 factor
    has a trailing update; the torch route and other dtypes never do."""
    port, _ = results
    k6 = port[gs][1]
    assert len(k6) == gs[0] * gs[1]
    for case in CASES:
        if case[0] != gs:
            continue
        key = _key(case)
        n, nb, dtype = case[1], case[2], case[3]
        for calls in k6:
            assert calls[f"{key}/torch"] == 0, key
            if dtype != F32:
                assert calls[f"{key}/kernel"] == 0, key
            elif -(-n // nb) > 1 and case[4] == "L":
                assert calls[f"{key}/kernel"] > 0, (key, calls)


def test_bucketed_case_takes_jax_bucketed_path(results):
    """The panel-width-16 case runs JAX's bucketed fori_loop path (and the
    port's unrolled loop): the other cases do not."""
    _, jax_refs = results
    for case in CASES:
        assert jax_refs[_key(case)][1] == (case[5] == 16), _key(case)


def test_cholesky_info_planted_pivot(results):
    port, jax_refs = results
    f, info = port[INFO_GRID][0]["info"]
    jf, jinfo = jax_refs["info"]
    assert info == jinfo
    tile = INFO_BAD // INFO_NB
    assert tile * INFO_NB < info <= (tile + 1) * INFO_NB
