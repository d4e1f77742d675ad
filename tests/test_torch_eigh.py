"""The eigensolver slice as a whole: dlaf_tpu_torch.eigh / eigvalsh against
dlaf_tpu.eigh / eigvalsh on the same numpy matrices, on the CPU (the
stage-2 kernel K3 runs its plain version here).

Both packages get the small-band parameters of tests/test_eigensolver.py
(eigensolver_min_band=8, default_block_size=16), so every stage runs at
these sizes. Eigenvalues are compared entry by entry with
tol(dtype, n, 2000) * max(1, max|A|) for f32/c64 and tol(dtype, n, 200) *
max(1, max|A|) for f64/c128 (tests/test_eigensolver.py:44). Eigenvectors
pass the gates of tests/test_eigensolver.py _check_eigh with the same
bound, and for separated spectra |V_port^H V_jax| is the identity within
it (each column agrees up to its sign or phase).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dlaf_tpu
import dlaf_tpu_torch as dtt
from dlaf_tpu.algos.eigensolver import band2tridiag as jb2t
from dlaf_tpu.algos.eigensolver.driver import get_band_size as jax_get_band_size
from dlaf_tpu_torch.algos.eigensolver import band2tridiag as b2t
from dlaf_tpu_torch.algos.eigensolver.driver import get_band_size
from dlaf_tpu_torch.ops.kernels import band2tridiag as kb2t

from conftest import tol

LOW = (np.dtype("float32"), np.dtype("complex64"))


@pytest.fixture(autouse=True)
def small_bands():
    small = dict(eigensolver_min_band=8, default_block_size=16)
    dlaf_tpu.set_tune_parameters(**small)
    dtt.set_tune_parameters(**small)
    yield
    dlaf_tpu.tune.reset_tune_parameters()
    dtt.reset_tune_parameters()


def _herm(n, dtype, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    if np.issubdtype(dtype, np.complexfloating):
        a = a + 1j * rng.standard_normal((n, n))
    return ((a + a.conj().T) / 2).astype(dtype)


def _bound(dtype, n, a):
    factor = 2000 if np.dtype(dtype) in LOW else 200
    return tol(dtype, n, factor) * max(1.0, float(np.max(np.abs(a))) if a.size else 1.0)


def _check(a, w, v, bound):
    """The gates of tests/test_eigensolver.py _check_eigh."""
    n = a.shape[0]
    assert np.all(np.diff(w) >= -bound), "eigenvalues not ascending"
    if n:
        assert np.abs(v.conj().T @ v - np.eye(n)).max() <= bound
        assert np.abs(a @ v - v * w[None, :]).max() <= bound


def _compare(a, dtype, uplo="L", separated=True, **kw):
    n = a.shape[0]
    before = kb2t.band_to_tridiag_strips_kernel.launches
    w, v = dtt.eigh(torch.from_numpy(a.copy()), uplo=uplo, **kw)
    assert kb2t.band_to_tridiag_strips_kernel.launches == before   # CPU: no kernel
    w0, v0 = dlaf_tpu.eigh(jnp.asarray(a), uplo=uplo, **kw)
    w, v, w0, v0 = w.numpy(), v.numpy(), np.asarray(w0), np.asarray(v0)
    assert w.shape == w0.shape == (n,) and v.shape == v0.shape == (n, n)
    assert w.dtype == w0.dtype and v.dtype == v0.dtype
    full = np.tril(a) + np.tril(a, -1).conj().T if uplo == "L" else \
        np.triu(a) + np.triu(a, 1).conj().T
    bound = _bound(dtype, n, full)
    assert np.abs(w - w0).max(initial=0) <= bound
    _check(full, w, v, bound)
    if separated and n:
        assert np.abs(np.abs(v.conj().T @ v0) - np.eye(n)).max() <= bound
    return w


@pytest.mark.parametrize("n", [1, 2, 5, 16, 34, 64])
def test_eigh_matches_jax(n, real_dtype_p):
    _compare(_herm(n, real_dtype_p, n + 1), real_dtype_p)


@pytest.mark.parametrize("cdtype", ["complex64", "complex128"])
@pytest.mark.parametrize("n", [5, 48])
def test_eigh_complex_matches_jax(n, cdtype):
    dtype = np.dtype(cdtype)
    _compare(_herm(n, dtype, n), dtype)


def test_eigh_empty():
    w, v = dtt.eigh(torch.zeros((0, 0), dtype=torch.float64))
    w0, v0 = dlaf_tpu.eigh(jnp.zeros((0, 0), jnp.float64))
    assert w.shape == w0.shape and v.shape == v0.shape


def test_eigh_uplo_upper():
    """Only the upper triangle is read: the lower one is poisoned."""
    n = 48
    a = _herm(n, np.float64, 3)
    poisoned = np.triu(a) + np.tril(np.full_like(a, 99.0), -1)
    _compare(poisoned, np.dtype("float64"), uplo="U")


def test_eigh_explicit_band():
    a = _herm(40, np.float64, 4)
    _compare(a, np.dtype("float64"), band=8)


def test_eigh_multiple_eigenvalues():
    n = 64
    d = np.repeat([1.0, 2.0, 3.0, 4.0], 16)
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = (q * d[None, :]) @ q.T
    a = (a + a.T) / 2
    w = _compare(a, np.dtype("float64"), separated=False)
    assert np.abs(w - np.sort(d)).max() < 1e-12


def test_eigvalsh_matches_jax(dtype):
    n = 64                                   # n % band == 0: eigvalsh's own path
    a = _herm(n, dtype, 7)
    w = dtt.eigvalsh(torch.from_numpy(a)).numpy()
    w0 = np.asarray(dlaf_tpu.eigvalsh(jnp.asarray(a)))
    assert w.shape == w0.shape == (n,)
    assert np.abs(w - w0).max() <= _bound(dtype, n, a)


def test_eigvalsh_upper_and_ragged():
    """uplo="U", and n % band != 0, which goes through eigh."""
    a = _herm(34, np.float64, 8)
    w = dtt.eigvalsh(torch.from_numpy(np.triu(a)), uplo="U").numpy()
    w0 = np.asarray(dlaf_tpu.eigvalsh(jnp.asarray(np.triu(a)), uplo="U"))
    assert np.abs(w - w0).max() <= _bound(np.float64, 34, a)
    assert np.abs(w - np.linalg.eigvalsh(a)).max() <= _bound(np.float64, 34, a)


def test_tune_carrier_gives_the_same_band_and_route(monkeypatch):
    """The JAX package's parameters, carried over by from_dict, give the
    same band size and the same stage-2 route on the CPU (the batched dense
    pipelined chase), and 'pallas' becomes 'kernel', which both packages
    refuse on the CPU."""
    for pallas in (False, True):
        if pallas:
            dlaf_tpu.set_tune_parameters(band_to_tridiag_kernel="pallas")
        params = dtt.from_dict(dataclasses.asdict(dlaf_tpu.get_tune_parameters()))
        dtt.reset_tune_parameters()
        dtt.set_tune_parameters(**dataclasses.asdict(params))
        assert get_band_size(params.default_block_size) == \
            jax_get_band_size(dlaf_tpu.get_tune_parameters().default_block_size) == 8
    assert params.band_to_tridiag_kernel == "kernel"
    band = np.triu(np.tril(_herm(24, np.float32, 9), 0), -8)
    band = band + np.tril(band, -1).T
    with pytest.raises(ValueError):
        jb2t.band_to_tridiag_auto(jnp.asarray(band), 8)
    with pytest.raises(ValueError):
        b2t.band_to_tridiag_auto(torch.from_numpy(band), 8)
    dlaf_tpu.set_tune_parameters(band_to_tridiag_kernel="auto")
    dtt.set_tune_parameters(band_to_tridiag_kernel="auto")
    calls = []
    monkeypatch.setattr(b2t, "band_to_tridiag_pipelined",
                        lambda x, b: calls.append(b) or b2t.band_to_tridiag(x, b))
    b2t.band_to_tridiag_auto(torch.from_numpy(band), 8)
    assert calls == [8]


def test_get_band_size_matches_jax():
    for mb, nb in ((64, 256), (8, 96), (64, 96), (128, 256)):
        dlaf_tpu.set_tune_parameters(eigensolver_min_band=mb)
        dtt.set_tune_parameters(eigensolver_min_band=mb)
        assert get_band_size(nb) == jax_get_band_size(nb)
