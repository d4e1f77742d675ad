"""The port's distributed eigensolver against the JAX package's.

The same numpy inputs (seeded) go through the JAX functions on the CPU
device mesh, as tests/test_dist_eigensolver.py, test_tridiag_dc_dist.py,
test_wavefront.py and ``__graft_entry__.dryrun_multichip`` run them, and
through the port: the 1x1 grid in this process, spawned gloo ranks on the
2x2, 2x3, 1x4 and 2x4 grids (one spawn per grid, in a background thread
while the JAX references run).

 - ``reduction_to_band_dist`` (f64, n = 64, nb = 8) on 2x2, 2x3 and 1x4:
   the packed lower triangle and the taus within 1e-12 of JAX's local
   ``reduction_to_band`` (the upper triangle legitimately differs); band 8
   < nb = 32 on 2x4 against the local reduction with band 8, and its band
   matrix's spectrum against numpy within 100 n eps;
 - ``eigh_dist`` (n = 64, nb = 16) on 1x1, 2x2, 2x3 and 1x4 in f64, with
   n = 70 (padding) on 2x3, and band 8 < nb on 2x2: eigenvalues entry by
   entry against JAX's ``eigh_dist`` (for the four grids' shared input,
   JAX's on its 2x2 mesh) and numpy's, orthogonality and
   residual, within 500 n eps (test_dist_eigensolver.py's bound);
   complex64 and complex128 on 2x2 within 2000 n eps; the ``pipelined``
   stage 2 (complex128 on 2x3, f64 on 2x2) at the same bounds;
 - ``eigvalsh_dist`` (2x4 n = 128, 2x3 n = 96) against JAX's and numpy's
   within 100 n eps max(1, max|w|) (2x4 against numpy's only, as the JAX
   test holds it);
 - ``eigh_gen_dist`` (2x2, n = 64): residual and B-orthogonality within
   2000 n eps max|A|, eigenvalues against JAX's at the same bound;
 - the gathered route (``_eigh_dist_gathered``, 2x2) against JAX's;
 - the replicated stage 2: d and e equal on every rank of the 2x2 grid;
 - MULTICHIP_r05.json's gevp (< 2000 n eps max|h|) and evp_pipelined
   (< 1000 n eps max|h|) bounds on a spawned 2x4 grid (n = 64, nb = 8,
   f64; the bounds of ``dryrun_multichip``, the eigenvalues against
   numpy's), beside the multichip case of test_torch_dist_blas.py;
 - the seven eigensolver miniapps' distributed branches with --check on
   the 2x2 grid.
"""
import concurrent.futures
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlaf_tpu.algos.eigensolver import dist_driver as jax_dd
from dlaf_tpu.algos.eigensolver.red2band import reduction_to_band as jax_red2band
from dlaf_tpu.comm.mesh import Grid as JaxGrid
from dlaf_tpu.matrix.dist_matrix import DistMatrix as JaxDistMatrix
from dlaf_tpu.tune import get_tune_parameters as jax_get_tune
from dlaf_tpu.tune import set_tune_parameters as jax_set_tune
from dlaf_tpu_torch.comm.launch import spawn_grid
from dlaf_tpu_torch.comm.mesh import Grid

import torch_dist_ranks as ranks

F64, C64, C128 = np.float64, np.complex64, np.complex128
GRIDS = [(1, 1), (2, 2), (2, 3), (1, 4), (2, 4)]
MINIAPP_COMMON = ["--check", "--nruns", "1", "--nwarmups", "0", "--device", "cpu",
                  "--comm-backend", "gloo", "--grid-rows", "2", "--grid-cols", "2"]
MINIAPP_RUNS = [("eigensolver", ["-n", "64", "-b", "16", "--type", "d"]),
                ("gen_eigensolver", ["-n", "64", "-b", "16", "--type", "d"]),
                ("reduction_to_band", ["-n", "64", "--band-size", "16", "--type", "d"]),
                ("band_to_tridiag", ["-n", "64", "--band-size", "8", "--type", "z"]),
                ("tridiag_solver", ["-n", "70", "--type", "d"]),
                ("bt_band_to_tridiag", ["-n", "64", "--band-size", "8", "--type", "z"]),
                ("bt_reduction_to_band", ["-n", "72", "--band-size", "24", "--type", "d"])]


def _eps(dtype):
    return np.finfo(dtype).eps


def _hermitian(n, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, n))
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.uniform(-1, 1, (n, n))
    return ((x + x.conj().T) / 2).astype(dtype)


def _spd(n, dtype, seed):
    return (_hermitian(n, dtype, seed) + n * np.eye(n)).astype(dtype)


def _cases():
    """[(grid, key, kind, arrays, kw)]."""
    out = []

    def add(gs, key, kind, arrays, **kw):
        out.append((gs, f"{gs[0]}x{gs[1]}-{key}", kind, arrays, kw))

    for i, gs in enumerate([(2, 2), (2, 3), (1, 4)]):
        add(gs, "red2band", "red2band", (_hermitian(64, F64, i),), nb=8, band=8)
    add((2, 4), "red2band-band-lt-nb", "red2band", (_hermitian(128, F64, 5),), nb=32, band=8)
    # one input on every grid, held to JAX's eigh_dist on the 2x2 mesh
    # (JAX's result does not depend on the grid; each of its grids is a
    # compile of several seconds)
    h64 = _hermitian(64, F64, 10)
    for gs in [(1, 1), (2, 2), (2, 3), (1, 4)]:
        add(gs, "eigh-f64", "eigh", (h64,), nb=16, jax_grid=(2, 2))
    add((2, 3), "eigh-f64-n70", "eigh", (_hermitian(70, F64, 15),), nb=16)
    add((2, 2), "eigh-band-lt-nb", "eigh", (_hermitian(128, F64, 16),), nb=32,
        tune=dict(eigensolver_min_band=8))
    for dtype in (C64, C128):
        add((2, 2), f"eigh-{np.dtype(dtype).name}", "eigh", (_hermitian(64, dtype, 17),), nb=16)
    add((2, 3), "eigh-c128-pipelined", "eigh", (_hermitian(64, C128, 18),), nb=16,
        tune=dict(band_to_tridiag_dist_mode="pipelined"))
    add((2, 2), "eigh-f64-pipelined", "eigh", (_hermitian(64, F64, 19),), nb=16,
        tune=dict(band_to_tridiag_dist_mode="pipelined"))
    add((2, 4), "evals", "evals", (_hermitian(128, F64, 20),), nb=16, jax_grid=None)
    add((2, 3), "evals", "evals", (_hermitian(96, F64, 21),), nb=16)
    add((2, 2), "gen", "gen", (_hermitian(64, F64, 22), _spd(64, F64, 23)), nb=16)
    add((2, 2), "gathered", "gathered", (_hermitian(64, F64, 24),), nb=16)
    add((2, 2), "stage2", "stage2", (_hermitian(64, F64, 25),), nb=16, band=8)
    add((2, 4), "multichip", "multichip", (_spd(64, F64, 1), _hermitian(64, F64, 3)), nb=8,
        jax_grid=None)
    return out


CASES = _cases()


def _run_port():
    out = {}
    for gs in GRIDS:
        cases = [(key, kind, arrays, kw) for g, key, kind, arrays, kw in CASES if g == gs]
        if gs == (1, 1):
            out.update(ranks.dist_eig_cases(cases, Grid(gs), torch.device("cpu")))
            continue
        fn = functools.partial(ranks.dist_eig_cases, cases)
        if gs == (2, 2):
            runs = [(name, argv + MINIAPP_COMMON) for name, argv in MINIAPP_RUNS]
            fn = functools.partial(ranks.eig_cases_and_miniapps, cases, runs)
        res = spawn_grid(fn, gs, backend="gloo", device="cpu", timeout=600)
        out.update(res[0])
        for key, kind, _, _ in cases:
            if kind == "stage2":
                out[key] = [r[key] for r in res]
        if gs == (2, 2):
            out["miniapps"] = [r["miniapps"] for r in res]
    return out


def _jax(gs, kind, arrays, kw):
    """JAX's result on the case's grid (``kw["jax_grid"]`` where given;
    None: no JAX reference, numpy's only, as the JAX test holds it)."""
    gs = kw.get("jax_grid", gs)
    if gs is None:
        return None
    grid = JaxGrid(gs)
    nb = kw.get("nb")

    def dm(x, pad=False):
        return JaxDistMatrix.from_global(jnp.asarray(x), nb, grid, pad_identity=pad)

    if kind == "red2band":
        packed, taus = jax_red2band(jnp.asarray(arrays[0]), kw["band"])
        return np.tril(np.asarray(packed)), np.asarray(taus)
    if kind in ("eigh", "gathered"):
        if kind == "gathered":
            w, v = jax_dd._eigh_dist_gathered(dm(arrays[0]), jax_get_tune().laed4_max_iter)
        else:
            w, v = jax_dd.eigh_dist(dm(arrays[0]))
        return np.asarray(w), np.asarray(v.to_global())
    if kind == "evals":
        return np.asarray(jax_dd.eigvalsh_dist(dm(arrays[0])))
    if kind == "gen":
        w, x = jax_dd.eigh_gen_dist(dm(arrays[0]), dm(arrays[1], True))
        return np.asarray(w), np.asarray(x.to_global())
    return None


def _with_tune(kw, fn):
    """``fn()`` under the case's tune parameters on the JAX side."""
    tune = kw.get("tune", {})
    old = {k: getattr(jax_get_tune(), k) for k in tune}
    jax_set_tune(**tune)
    try:
        return fn()
    finally:
        jax_set_tune(**old)


@pytest.fixture(scope="module")
def results():
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(_run_port)
        jax_refs = {key: _with_tune(kw, functools.partial(_jax, gs, kind, arrays, kw))
                    for gs, key, kind, arrays, kw in CASES}
        return port.result(), jax_refs


def _of(kind):
    return [c for c in CASES if c[2] == kind]


def _param(kind):
    return pytest.mark.parametrize("case", _of(kind), ids=[c[1] for c in _of(kind)])


@_param("red2band")
def test_red2band_dist_matches_local(results, case):
    port, jax_refs = results
    _, key, _, (a,), kw = case
    n = a.shape[0]
    packed, taus = port[key]
    want_packed, want_taus = jax_refs[key]
    np.testing.assert_allclose(packed[:n, :n], want_packed, rtol=0, atol=1e-12)
    np.testing.assert_allclose(taus[:n], want_taus, rtol=0, atol=1e-12)
    band = kw["band"]
    bandm = np.tril(np.triu(packed[:n, :n], -band))
    bandm = bandm + np.tril(bandm, -1).conj().T
    ref = np.linalg.eigvalsh(a)
    assert np.abs(np.linalg.eigvalsh(bandm) - ref).max() <= \
        100 * n * _eps(F64) * max(np.abs(ref).max(), 1)


@_param("eigh")
def test_eigh_dist_matches_jax(results, case):
    port, jax_refs = results
    _, key, _, (a,), _ = case
    n = a.shape[0]
    w, v = port[key]
    w_jax, v_jax = jax_refs[key]
    factor = 2000 if a.dtype.kind == "c" else 500
    bound = factor * n * _eps(a.dtype)
    assert w.dtype.kind == "f"
    ref = np.linalg.eigvalsh(a.astype(np.complex128 if a.dtype.kind == "c" else F64))
    assert np.abs(w - ref).max() <= bound
    assert np.abs(w - w_jax).max() <= bound
    assert np.abs(v.conj().T @ v - np.eye(n)).max() <= bound
    assert np.abs(a @ v - v * w[None, :]).max() <= bound * np.abs(a).max()
    # JAX's vectors pass the same gates (the two are equal up to a phase
    # a column)
    assert np.abs(a @ v_jax - v_jax * w_jax[None, :]).max() <= bound * np.abs(a).max()


@_param("evals")
def test_eigvalsh_dist_matches_jax(results, case):
    port, jax_refs = results
    _, key, _, (a,), _ = case
    n = a.shape[0]
    ref = np.linalg.eigvalsh(a)
    bound = 100 * n * _eps(F64) * max(np.abs(ref).max(), 1)
    assert np.abs(port[key] - ref).max() <= bound
    if jax_refs[key] is not None:
        assert np.abs(port[key] - jax_refs[key]).max() <= bound


def test_eigh_gen_dist_matches_jax(results):
    port, jax_refs = results
    (_, key, _, (a, b), _), = _of("gen")
    n = a.shape[0]
    w, x = port[key]
    w_jax, _ = jax_refs[key]
    bound = 2000 * n * _eps(F64) * np.abs(a).max()
    assert np.abs(a @ x - b @ x * w[None, :]).max() <= bound
    assert np.abs(x.T @ b @ x - np.eye(n)).max() <= bound
    assert np.abs(w - w_jax).max() <= bound


def test_eigh_dist_gathered_route_matches_jax(results):
    port, jax_refs = results
    (_, key, _, (a,), _), = _of("gathered")
    n = a.shape[0]
    w, v = port[key]
    w_jax, _ = jax_refs[key]
    bound = 500 * n * _eps(F64)
    assert np.abs(w - w_jax).max() <= bound
    assert np.abs(v.T @ v - np.eye(n)).max() <= bound
    assert np.abs(a @ v - v * w[None, :]).max() <= bound * np.abs(a).max()


def test_replicated_stage2_equal_on_every_rank(results):
    """Every rank chases the same band (K3 on the card, its plain version
    here): d and e are bit-equal across the ranks; each rank records its
    sweep chunk, ceil(nsweeps / 4) sweeps."""
    port, _ = results
    (_, key, _, _, _), = _of("stage2")
    outs = port[key]
    d0, e0, _ = outs[0]
    for d, e, shape in outs:
        np.testing.assert_array_equal(d, d0)
        np.testing.assert_array_equal(e, e0)
        assert shape[0] == -(-(64 - 2) // 4)


def test_multichip_gevp_and_pipelined(results):
    """MULTICHIP_r05.json's gevp and evp_pipelined residuals
    (``__graft_entry__.py:112-135``) on a spawned 2x4 grid."""
    port, jax_refs = results
    (_, key, _, (spd_a, h), _), = _of("multichip")
    n = h.shape[0]
    w, x, wp, vp = port[key]
    hmax = max(np.abs(h).max(), 1.0)
    eps = _eps(F64)
    resg = np.abs(h @ x - spd_a @ x * w[None, :]).max()
    assert resg < 2000 * n * eps * hmax, resg
    resp = np.abs(h @ vp - vp * wp[None, :]).max()
    assert resp < 1000 * n * eps * hmax, resp
    # the pencil's eigenvalues (numpy's, through the Cholesky factor) and
    # the standard problem's
    lf = np.linalg.cholesky(spd_a)
    linv = np.linalg.inv(lf)
    assert np.abs(w - np.linalg.eigvalsh(linv @ h @ linv.T)).max() < 2000 * n * eps * hmax
    assert np.abs(wp - np.linalg.eigvalsh(h)).max() < 1000 * n * eps * hmax


@pytest.mark.parametrize("i", range(len(MINIAPP_RUNS)),
                         ids=[name for name, _ in MINIAPP_RUNS])
def test_distributed_miniapps(results, i):
    port, _ = results
    outs = port["miniapps"]
    assert "check: PASSED" in outs[0][i], outs[0][i]
    row = [l for l in outs[0][i].splitlines() if l.startswith("CSVData-2")]
    assert len(row) == 1 and [f.strip() for f in row[0].split(",")][8:10] == ["2", "2"]
    assert all(o[i] == "" for o in outs[1:])      # only rank 0 prints
