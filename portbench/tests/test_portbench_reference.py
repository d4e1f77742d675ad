"""The plain references accept a true answer and reject a planted wrong one."""
import numpy as np
import pytest
import torch

from portbench import traffic
from portbench.reference import cholesky as ref_chol
from portbench.reference import eigh as ref_eigh

LIMIT = 3e-6     # the Cholesky cells' limit on factor_err


def _spd(n, seed=5):
    return traffic.make_matrix({"n": n, "dtype": "float32", "diag_shift_sqrt_n": 2.0}, seed, "cpu")


def _factor_as_called(a):
    """The f32 factor in the lower triangle, the strict upper kept."""
    low = torch.linalg.cholesky(a)
    return torch.where(torch.ones_like(a, dtype=torch.bool).tril(), low, a)


def test_cholesky_judge_accepts_a_true_factor():
    a = _spd(160)
    r = ref_chol.judge(a, _factor_as_called(a))
    assert r["factor_err"] < LIMIT / 10 and r["other_changed"] == 0


def test_cholesky_judge_takes_numpy_and_upper():
    a = _spd(96)
    f = _factor_as_called(a.mH.contiguous()).mH.contiguous()
    r = ref_chol.judge(a, f.numpy(), uplo="U")
    assert r["factor_err"] < LIMIT / 10 and r["other_changed"] == 0


@pytest.mark.parametrize("where", ["diagonal", "below", "last_row"])
def test_cholesky_judge_rejects_one_altered_entry(where):
    a = _spd(160)
    f = _factor_as_called(a)
    i, j = {"diagonal": (70, 70), "below": (100, 37), "last_row": (159, 3)}[where]
    f[i, j] += 1e-3 * f[i, i]
    assert ref_chol.judge(a, f)["factor_err"] > LIMIT


def test_cholesky_judge_rejects_the_input_returned():
    a = _spd(96)
    assert ref_chol.judge(a, a.clone())["factor_err"] > 0.1


def test_cholesky_judge_counts_a_changed_other_triangle():
    a = _spd(96)
    f = _factor_as_called(a)
    f[3, 90] = 0.0
    assert ref_chol.judge(a, f)["other_changed"] == 1


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_blocked_cholesky_is_the_reference(uplo):
    a = _spd(130).double()
    out = ref_chol.blocked_cholesky(a, 32, uplo)
    r = ref_chol.judge(a, out, uplo)
    assert r["factor_err"] < 1e-13 and r["other_changed"] == 0


def _herm(n, seed=6):
    return traffic.make_matrix({"n": n, "dtype": "float32", "diag_shift_sqrt_n": 0.0}, seed, "cpu")


def test_eigh_judge_accepts_a_true_decomposition():
    a = _herm(128)
    w, v = torch.linalg.eigh(a)
    r = ref_eigh.judge(a, w, v)
    assert r["resid"] < 1e-5 and r["orth"] < 1e-5 and r["eig_err"] < 1e-5
    assert ref_eigh.judge(a, w.numpy(), v.numpy()) == r


def test_eigh_judge_rejects_a_duplicated_vector():
    a = _herm(128)
    w, v = torch.linalg.eigh(a)
    v[:, 5] = v[:, 6]
    w[5] = w[6]
    assert ref_eigh.judge(a, w, v)["orth"] > 0.5


def test_eigh_judge_rejects_a_shifted_eigenvalue():
    a = _herm(128)
    w, v = torch.linalg.eigh(a)
    w[40] += 1e-2 * float(w.abs().max())
    assert ref_eigh.judge(a, w, v)["resid"] > 5e-3


def test_same_seed_same_matrix():
    p = {"n": 64, "dtype": "float32", "diag_shift_sqrt_n": 2.0}
    a, b = traffic.make_matrix(p, 2**31 + 7, "cpu"), traffic.make_matrix(p, 2**31 + 7, "cpu")
    assert torch.equal(a, b) and torch.equal(a, a.mH)
    assert not torch.equal(a, traffic.make_matrix(p, 2**31 + 8, "cpu"))
    assert np.all(np.linalg.eigvalsh(a.double().numpy()) > 0)
