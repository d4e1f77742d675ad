"""The slice as a whole: dlaf_tpu_torch.potrf / potrf_info against
dlaf_tpu.potrf / potrf_info on the same numpy inputs (the oracle set of
tests/test_blas_local.py: {s,d,c,z} x uplo x n in {1, 7, 64, 130, 300}, nb=64).

Only the factor's triangle is compared: with clean=False the other
triangle keeps the input in both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dlaf_tpu
import dlaf_tpu_torch
from dlaf_tpu_torch.ops import leaf
from dlaf_tpu_torch.ops.kernels.trailing import ksub_matmul

from conftest import tol

SIZES = [1, 7, 64, 130, 300]


def _spd(n, dtype, seed):
    """Hermitian positive definite, eigenvalues in ~[n/2, 3n/2] (the
    distribution of the generators of both packages)."""
    rng = np.random.default_rng(seed)
    d = np.dtype(dtype)
    r = rng.uniform(-1, 1, (n, n))
    if d.kind == "c":
        r = r + 1j * rng.uniform(-1, 1, (n, n))
    return ((r + r.conj().T) / 2 + n * np.eye(n)).astype(d)


def _tri(f, uplo):
    return np.tril(f) if uplo == "L" else np.triu(f)


def _compare(a, uplo, nb, clean=True):
    n = a.shape[0]
    ta = torch.from_numpy(a.copy())
    got = dlaf_tpu_torch.potrf(ta, uplo=uplo, nb=nb, clean=clean).resolve_conj().numpy()
    np.testing.assert_array_equal(ta.numpy(), a)      # the caller's tensor is kept
    want = np.asarray(dlaf_tpu.potrf(jnp.asarray(a), uplo=uplo, nb=nb, clean=clean))
    scale = max(np.abs(want).max(), 1.0)
    assert np.abs(_tri(got, uplo) - _tri(want, uplo)).max() <= tol(a.dtype, n) * scale
    return got, want


@pytest.mark.parametrize("dtype", ["float32", "float64", "complex64", "complex128"])
@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("n", SIZES)
def test_potrf_matches_jax(n, uplo, dtype):
    a = _spd(n, dtype, n)
    got, _ = _compare(a, uplo, nb=64)
    other = np.triu(got, 1) if uplo == "L" else np.tril(got, -1)
    assert not other.any()


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_potrf_unclean_matches_jax(uplo):
    a = _spd(130, "float32", 1)
    got, want = _compare(a, uplo, nb=64, clean=False)
    # the other triangle keeps the input outside the diagonal leaf tiles
    # (which hold the leaf factors), in both packages alike
    other, k = (np.triu, 1) if uplo == "L" else (np.tril, -1)
    np.testing.assert_array_equal(other(got, k), other(want, k))
    off = np.s_[:64, 64:] if uplo == "L" else np.s_[64:, :64]
    np.testing.assert_array_equal(got[off], a[off])


@pytest.mark.parametrize("mode", ["torch", "kernel"])
def test_potrf_trailing_modes(mode, monkeypatch):
    """Both trailing routes of the upper factor give JAX's factor; the
    "kernel" route goes through the K2 wrapper (its plain version on the
    CPU), the "torch" route does not."""
    calls = []
    from dlaf_tpu_torch.ops import blocked

    def spy(*a, **k):
        calls.append(1)
        return ksub_matmul(*a, **k)

    monkeypatch.setattr(blocked, "ksub_matmul", spy)
    dlaf_tpu_torch.set_tune_parameters(potrf_trailing_kernel=mode)
    try:
        _compare(_spd(130, "float32", 2), "U", nb=64)
    finally:
        dlaf_tpu_torch.reset_tune_parameters()
    assert bool(calls) == (mode == "kernel")


def test_potrf_forced_torch_leaf():
    leaf.set_leaf_backend("torch")
    try:
        _compare(_spd(130, "float32", 3), "L", nb=64)
    finally:
        leaf.set_leaf_backend(None)


def test_potrf_rejects_bad_input():
    with pytest.raises(ValueError, match="uplo"):
        dlaf_tpu_torch.potrf(torch.eye(4), uplo="X")
    with pytest.raises(ValueError, match="square"):
        dlaf_tpu_torch.potrf(torch.zeros(4, 3))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_potrf_info_local(dtype, uplo):
    n = 96
    a = _spd(n, dtype, 4)
    _, info = dlaf_tpu_torch.potrf_info(torch.from_numpy(a), uplo=uplo, nb=32)
    assert info.dtype == torch.int32 and int(info) == 0
    bad = a.copy()
    bad[70, 70] = -50.0
    _, info_bad = dlaf_tpu_torch.potrf_info(torch.from_numpy(bad), uplo=uplo, nb=32)
    _, info_jax = dlaf_tpu.potrf_info(jnp.asarray(bad), uplo=uplo, nb=32)
    # info points into the failing tile (tile-granular, like potrfInfo)
    assert 64 < int(info_bad) <= 96
    assert 64 < int(info_jax) <= 96
