"""The slice as a whole: dlaf_tpu_torch.eigh_large / eigvalsh_large against
dlaf_tpu's eigh_large / eigvalsh_large on the same numpy matrices, on the
CPU (kernels K3, K4 and K5 run their plain versions here).

Cases (n, band, rec_chunks): (128, 32, 1) in f32 and f64 with the default
group size (128 != band: the cooked grouped apply); (160, 32, 1) with group
size 32 and bt_apply_fuse_groups = 4 (5 groups: one through K4, one fused
step of 4 through K5); (192, 32, 3) with group size 32 (three re-chased
chunks through the shifted apply); complex64 (128, 32, 1) (the cooked
route with the phases folded in). Eigenvalues are compared entry by entry
within tol(dtype, n) * max(1, max|A|); eigenvectors pass the gates of
tests/test_eigh_large.py _check (factor 60).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dlaf_tpu
import dlaf_tpu_torch as dtt
from dlaf_tpu.algos.eigensolver import large as jlarge
from dlaf_tpu_torch.algos.eigensolver import bt as tbt
from dlaf_tpu_torch.algos.eigensolver import large as tlarge

from conftest import tol


def _herm(n, dtype, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    if np.issubdtype(dtype, np.complexfloating):
        a = a + 1j * rng.standard_normal((n, n))
    return ((a + a.conj().T) / 2).astype(dtype)


def _check(an, w, v, dtype, factor=60):
    """The gates of tests/test_eigh_large.py _check."""
    n = an.shape[0]
    eps = np.finfo(dtype).eps
    scale = max(np.abs(an).max(), 1.0)
    assert np.all(np.diff(w) >= -tol(dtype, n))
    assert np.abs(v.conj().T @ v - np.eye(n)).max() <= factor * n * eps
    assert np.abs(an @ v - v * w[None, :]).max() <= factor * n * eps * scale
    assert np.abs(w - np.linalg.eigvalsh(an.astype(np.complex128 if np.iscomplexobj(an)
                                                   else np.float64))).max() \
        <= factor * n * eps * scale


@pytest.fixture
def params(request):
    """Both packages' tune parameters set to request.param."""
    kw = request.param
    dlaf_tpu.set_tune_parameters(**kw)
    dtt.set_tune_parameters(**kw)
    yield kw
    dlaf_tpu.tune.reset_tune_parameters()
    dtt.reset_tune_parameters()


def _spy(monkeypatch):
    """Count the calls of K4 and K5 made by the shifted apply."""
    calls = {"bt_apply_group": 0, "bt_apply_fused": 0}
    for name in calls:
        real = getattr(tbt, name)

        def spy(*a, _real=real, _name=name):
            calls[_name] += 1
            return _real(*a)
        monkeypatch.setattr(tbt, name, spy)
    return calls


GROUP32 = dict(bt_band_to_tridiag_hh_apply_group_size=32)


@pytest.mark.parametrize("n,b,chunks,dtype,params,k45", [
    (128, 32, 1, np.float32, {}, (0, 0)),
    (128, 32, 1, np.float64, {}, (0, 0)),
    (160, 32, 1, np.float32, dict(GROUP32, bt_apply_fuse_groups=4), (1, 1)),
    (192, 32, 3, np.float32, GROUP32, (0, 3)),
    (128, 32, 1, np.complex64, {}, (0, 0)),
], indirect=["params"])
def test_eigh_large_matches_jax(monkeypatch, n, b, chunks, dtype, params, k45):
    an = _herm(n, dtype, n + chunks)
    calls = _spy(monkeypatch)
    w, v = dtt.eigh_large(torch.from_numpy(an.copy()), band=b, rec_chunks=chunks)
    assert (calls["bt_apply_group"], calls["bt_apply_fused"]) == k45
    wj, _ = jlarge.eigh_large(jnp.asarray(an.copy()), band=b, rec_chunks=chunks)
    rdt = np.finfo(dtype).dtype
    w, v = w.numpy(), v.numpy()
    assert w.dtype == rdt and v.dtype == dtype and v.shape == (n, n)
    bound = tol(rdt, n) * max(np.abs(an).max(), 1.0)
    assert np.abs(w - np.asarray(wj)).max() <= bound
    _check(an, w, v, rdt)


def test_eigh_large_leaves_its_input_and_matches_eigvalsh_large():
    n, b = 128, 32
    an = _herm(n, np.float32, 1)
    a = torch.from_numpy(an.copy())
    w, _ = dtt.eigh_large(a, band=b)
    assert np.array_equal(a.numpy(), an)
    wv = dtt.eigvalsh_large(a, band=b)
    assert torch.equal(wv, w)                      # stages 1-3 are the same calls
    wj = jlarge.eigvalsh_large(jnp.asarray(an.copy()), band=b)
    assert np.abs(wv.numpy() - np.asarray(wj)).max() <= tol(np.float32, n) * np.abs(an).max()


def test_eigh_large_timers_and_guards():
    a = torch.from_numpy(_herm(128, np.float32, 3))
    w0, v0 = dtt.eigh_large(a, band=32)
    w, v, stage_s = dtt.eigh_large(a, band=32, timers=True)
    assert set(stage_s) == {
        "stage1_red2band", "stage2_band2tridiag", "stage3_tridiag_dc",
        "stage4_bt_band2tridiag", "stage4a_rechase", "stage4b_apply", "stage5_bt_red2band"}
    assert stage_s["stage4a_rechase"] == 0.0       # rec_chunks = 1: no re-chase
    assert stage_s["stage4a_rechase"] + stage_s["stage4b_apply"] <= \
        stage_s["stage4_bt_band2tridiag"] * 1.01 + 0.05
    assert tlarge.stage_peak_bytes == {}           # measured on a CUDA tensor only
    assert torch.equal(w, w0) and torch.equal(v, v0)
    for bad, band in ((torch.zeros((100, 100)), 32), (torch.zeros((32, 32)), 32)):
        with pytest.raises(ValueError):
            dtt.eigh_large(bad, band=band)         # n % b, n <= b
        with pytest.raises(ValueError):
            dtt.eigvalsh_large(bad, band=band)
    with pytest.raises(ValueError):
        dtt.eigh_large(a, band=32, rec_chunks=0)


@pytest.mark.parametrize("dtype,gsz,want", [
    (torch.float32, 128, True), (torch.float32, 64, False),
    (torch.float64, 128, False), (torch.complex64, 128, False)])
def test_shifted_apply_route_depends_on_shape_and_dtype_only(dtype, gsz, want):
    assert tlarge._use_shifted_apply(128, gsz, dtype) is want
