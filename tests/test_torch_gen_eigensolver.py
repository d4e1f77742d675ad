"""The generalized eigensolver slice against the JAX package on the same
numpy matrices: dlaf_tpu_torch.hegst against
dlaf_tpu.algos.gen_to_std.generalized_to_standard (uplo L and U), and
dlaf_tpu_torch.eigh_gen against dlaf_tpu.eigh_gen (factorized or not,
uplo L and U); then the four new miniapps on the CPU with --check, and
the distributed branches of the triangular solver, triangular
multiplication and gen_to_std miniapps on a 2x2 grid of spawned gloo ranks.

Both packages get the small-band parameters of tests/test_eigensolver.py
(eigensolver_min_band=8, default_block_size=16). hegst is held to
tol(dtype, n, 500) (tests/test_aux.py test_gen_to_std); eigh_gen's sorted
eigenvalues entry by entry, and its eigenvectors (unique only up to phase)
through the residual and B-orthogonality gates of
tests/test_eigensolver.py test_eigh_gen, 1000 n eps max|A|.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dlaf_tpu
import dlaf_tpu_torch as dtt
from dlaf_tpu.algos.gen_to_std import generalized_to_standard
from dlaf_tpu_torch.miniapps import (miniapp_gen_eigensolver, miniapp_gen_to_std,
                                     miniapp_triangular_multiplication,
                                     miniapp_triangular_solver)
from dlaf_tpu_torch.ops import leaf
from dlaf_tpu_torch.ops.kernels import potrf as kpotrf

from conftest import tol


@pytest.fixture(autouse=True)
def small_bands():
    small = dict(eigensolver_min_band=8, default_block_size=16)
    dlaf_tpu.set_tune_parameters(**small)
    dtt.set_tune_parameters(**small)
    yield
    dlaf_tpu.tune.reset_tune_parameters()
    dtt.reset_tune_parameters()


def _general(n, dtype, rng):
    x = rng.uniform(-1, 1, (n, n))
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.uniform(-1, 1, (n, n))
    return x


def _pencil(n, dtype, seed):
    """A hermitian (elements O(1)), B hermitian positive definite with
    eigenvalues in ~[n/2, 3n/2]: the generators' laws."""
    rng = np.random.default_rng(seed)
    a = _general(n, dtype, rng)
    b = _general(n, dtype, rng)
    a = (a + a.conj().T) / 2
    b = (b + b.conj().T) / 2 + n * np.eye(n)
    return a.astype(dtype), b.astype(dtype)


def _poison(x, uplo):
    """Only the ``uplo`` triangle is meant to be read: 99 in the other."""
    junk = np.full_like(x, 99.0)
    return np.tril(x) + np.triu(junk, 1) if uplo == "L" else np.triu(x) + np.tril(junk, -1)


@pytest.mark.parametrize("dtype", ["float64", "complex128", "float32"])
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_hegst_matches_jax(uplo, dtype):
    n = 64
    a, b = _pencil(n, dtype, 2)
    c = np.linalg.cholesky(b.astype(np.complex128 if np.dtype(dtype).kind == "c" else
                                    np.float64)).astype(dtype)
    f = c if uplo == "L" else c.conj().T
    ap, fp = _poison(a, uplo), _poison(f, uplo)
    ta, tf = torch.from_numpy(ap.copy()), torch.from_numpy(fp.copy())
    got = dtt.hegst(ta, tf, uplo=uplo, nb=16).numpy()
    np.testing.assert_array_equal(ta.numpy(), ap)
    np.testing.assert_array_equal(tf.numpy(), fp)
    want = np.asarray(generalized_to_standard(jnp.asarray(ap), jnp.asarray(fp), uplo=uplo,
                                              nb=16))
    assert np.abs(got - want).max() <= tol(dtype, n, 500)
    # and the definition: F^-1 A F^-H (L) or F^-H A F^-1 (U), in f64
    fi = np.linalg.inv(f.astype(np.complex128))
    ref = fi @ a @ fi.conj().T if uplo == "L" else fi.conj().T @ a @ fi
    assert np.abs(got - ref).max() <= tol(dtype, n, 500)


def _check_gen(a, b, w, x, bound):
    """tests/test_eigensolver.py test_eigh_gen's gates."""
    n = a.shape[0]
    assert np.all(np.diff(w) >= -bound)
    assert np.abs(a @ x - b @ x * w[None, :]).max() <= bound
    assert np.abs(x.conj().T @ b @ x - np.eye(n)).max() <= bound


@pytest.mark.parametrize("dtype,n", [("float64", 80), ("complex128", 64)])
@pytest.mark.parametrize("factorized", [False, True])
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_eigh_gen_matches_jax(uplo, factorized, dtype, n):
    a, b = _pencil(n, dtype, 3)
    if factorized:
        c = np.linalg.cholesky(b)
        b_in = c if uplo == "L" else c.conj().T
    else:
        b_in = b
    ap, bp = _poison(a, uplo), _poison(b_in, uplo)
    ta, tb = torch.from_numpy(ap.copy()), torch.from_numpy(bp.copy())
    w, x = dtt.eigh_gen(ta, tb, uplo=uplo, factorized=factorized)
    np.testing.assert_array_equal(ta.numpy(), ap)
    np.testing.assert_array_equal(tb.numpy(), bp)
    w, x = w.numpy(), x.resolve_conj().numpy()
    wj, _ = dlaf_tpu.eigh_gen(jnp.asarray(ap), jnp.asarray(bp), uplo=uplo,
                              factorized=factorized)
    bound = tol(dtype, n, 1000) * np.abs(a).max()
    assert np.abs(w - np.asarray(wj)).max() <= bound
    _check_gen(a, b, w, x, bound)


def test_eigh_gen_f32_launch_path(monkeypatch):
    """f32 factors B through K1's wrapper (its plain version on the CPU)
    and meets the miniapp's gates."""
    calls = []
    real = kpotrf.potrf_tile

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(leaf, "potrf_tile", spy)
    n = 96
    a, b = _pencil(n, "float32", 4)
    w, x = dtt.eigh_gen(torch.from_numpy(a), torch.from_numpy(b))
    ok, res, borth = miniapp_gen_eigensolver.check_eigh_gen(
        torch.from_numpy(a), torch.from_numpy(b), w, x, torch.float32)
    assert ok, (res, borth)
    assert calls


def _csv(out):
    rows = [r for r in out.splitlines() if r.startswith("CSVData-2")]
    assert len(rows) == 1
    return [f.strip() for f in rows[0].split(",")]


MINIAPPS = {"triangular_solver": (miniapp_triangular_solver, ["-n", "100", "-b", "32"]),
            "triangular_multiplication": (miniapp_triangular_multiplication,
                                          ["-n", "100", "-b", "32", "--m", "40"]),
            "gen_to_std": (miniapp_gen_to_std, ["-n", "96", "-b", "32"]),
            "gen_eigensolver": (miniapp_gen_eigensolver, ["-n", "64"])}


@pytest.mark.parametrize("typ", ["s", "d", "z"])
@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("name", list(MINIAPPS))
def test_miniapps_cpu_check(name, uplo, typ, capsys):
    mod, argv = MINIAPPS[name]
    mod.main(argv + ["--check", "--nruns", "1", "--nwarmups", "0", "--type", typ,
                     "--uplo", uplo, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "check: PASSED" in out
    row = _csv(out)
    assert row[4:6] == [typ, uplo] and row[8:] == ["1", "1", "1", "cpu"]


DISTRIBUTED = ("triangular_solver", "triangular_multiplication", "gen_to_std")


@pytest.mark.parametrize("name", list(MINIAPPS))
def test_miniapps_grid_not_ported(name):
    """A grid larger than 1x1: every one of these miniapps has a
    distributed branch, and refuses to run it outside torchrun (no process
    group, world size 1), naming the command."""
    mod, argv = MINIAPPS[name]
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        mod.main(argv + ["--grid-rows", "2", "--device", "cpu"])


DIST_RUNS = [(name, uplo) for name in DISTRIBUTED for uplo in "LU"]


@pytest.fixture(scope="module")
def distributed_runs():
    """The three distributed branches, uplo L and U, with --check on one 2x2
    grid of spawned gloo ranks (in f64, n ragged against nb); what each
    rank printed, per run."""
    import functools

    import torch_dist_ranks as ranks
    from dlaf_tpu_torch.comm.launch import spawn_grid

    runs = [(name, MINIAPPS[name][1][:2] + ["-b", "16", "--grid-rows", "2", "--grid-cols", "2",
                                            "--uplo", uplo, "--type", "d", "--check",
                                            "--nruns", "1", "--nwarmups", "0", "--device",
                                            "cpu", "--comm-backend", "gloo"]
             + MINIAPPS[name][1][4:])
            for name, uplo in DIST_RUNS]
    outs = spawn_grid(functools.partial(ranks.miniapps, runs), (2, 2), backend="gloo",
                      device="cpu", timeout=300)
    return {run: [o[i] for o in outs] for i, run in enumerate(DIST_RUNS)}


@pytest.mark.parametrize("name,uplo", DIST_RUNS, ids=[f"{n}-{u}" for n, u in DIST_RUNS])
def test_miniapps_distributed(distributed_runs, name, uplo):
    """The distributed branch on a 2x2 grid: rank 0 prints the run and
    --check passes; the other ranks print nothing."""
    outs = distributed_runs[(name, uplo)]
    assert "check: PASSED" in outs[0], outs[0]
    n = MINIAPPS[name][1][1]
    assert _csv(outs[0])[4:] == ["d", uplo, n, "16", "2", "2", "1", "cpu"]
    assert outs[1:] == ["", "", ""]


def test_triangular_solver_check_rejects_planted_fault(monkeypatch, capsys):
    """The solver miniapp's check fails a solution with one entry off by 0.1."""
    real = dtt.trsm

    def bad(*args, **kw):
        x = real(*args, **kw).clone()
        x[3, 2] += 0.1      # the bound is 500 m eps32 = 6.0e-3 at m = 100
        return x

    monkeypatch.setattr(dtt, "trsm", bad)
    with pytest.raises(SystemExit):
        miniapp_triangular_solver.main(["-n", "100", "-b", "32", "--check", "--nruns", "1",
                                        "--nwarmups", "0", "--device", "cpu"])
    assert "check: FAILED" in capsys.readouterr().out
