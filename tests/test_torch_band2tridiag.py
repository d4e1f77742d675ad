"""Stage 2 of the port (band -> tridiagonal) and kernel K3's plain version
against the JAX package.

The same numpy band matrices go through the JAX functions and their ports:
strip storage, the dense sequential and pipelined chases, the sequential
strip chase (with sweep chunking), and K3's plain version against the JAX
Pallas K3 run in interpret mode, as tests/test_band_strips.py runs it.
Tolerances (tests/test_band_strips.py:70, tests/test_eigensolver.py:44):
tol(dtype, n, 2000) * max(1, max|A|) for f32/c64 and tol(dtype, n, 200) *
max(1, max|A|) for f64/c128, on d, e, taus and, where tau != 0, on the
reflectors (a tau = 0 slot is a no-op whose head convention differs).
The CUDA cases skip here: the kernel runs only on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dlaf_tpu
import dlaf_tpu_torch as dtt
from dlaf_tpu.algos.eigensolver import band2tridiag as jb2t
from dlaf_tpu.algos.eigensolver import band_strips as jbs
from dlaf_tpu_torch.algos.eigensolver import band2tridiag as b2t
from dlaf_tpu_torch.algos.eigensolver import band_strips as bs
from dlaf_tpu_torch.ops.kernels import _build
from dlaf_tpu_torch.ops.kernels import band2tridiag as kb2t

from conftest import tol

LOW = (np.dtype("float32"), np.dtype("complex64"))


def _band(n, b, dtype, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    if np.issubdtype(dtype, np.complexfloating):
        a = a + 1j * rng.standard_normal((n, n))
    a = a + a.conj().T
    i = np.arange(n)
    return np.where(np.abs(i[:, None] - i[None, :]) <= b, a, 0).astype(dtype)


def _bound(dtype, n, a):
    factor = 2000 if np.dtype(dtype) in LOW else 200
    return tol(dtype, n, factor) * max(1.0, float(np.max(np.abs(a))))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_stage2(got, want, bound):
    """(d, e, vs, taus) of the port against the JAX package's."""
    d, e, vs, taus = (_np(x) for x in got)
    d0, e0, vs0, t0 = (_np(x) for x in want)
    assert d.shape == d0.shape and e.shape == e0.shape and vs.shape == vs0.shape
    assert np.abs(d - d0).max(initial=0) <= bound
    assert np.abs(e - e0).max(initial=0) <= bound
    assert np.abs(taus - t0).max(initial=0) <= bound
    act = (t0 != 0)[:, :, None]
    assert (np.abs(vs - vs0) * act).max(initial=0) <= bound


# ------------------------------------------------------------ strip storage


@pytest.mark.parametrize("n,b", [(37, 4), (20, 16), (64, 8)])
def test_strips_layout_matches_jax(dtype, n, b):
    band = _band(n, b, dtype)
    strips = bs.band_to_strips(torch.from_numpy(band), b)
    want = np.asarray(jbs.band_to_strips(jnp.asarray(band), b))
    assert strips.shape == (bs.n_strips(n, b), b, bs.STRIP_W * b)
    assert np.array_equal(strips.numpy(), want)
    d, e = bs.strips_extract_tridiag(strips, n, b)
    assert np.array_equal(d.numpy(), np.real(np.diagonal(band)))
    assert np.array_equal(e.numpy(), np.diagonal(band, -1))


def test_packed_to_strips_masks_the_reflectors(dtype):
    n, b = 40, 8
    band = _band(n, b, dtype)
    packed = np.tril(band) + np.tril(np.full_like(band, 7), -b - 1)   # junk below the band
    got = bs.packed_to_strips(torch.from_numpy(packed), b).numpy()
    assert np.array_equal(got, np.asarray(jbs.packed_to_strips(jnp.asarray(packed), b)))
    assert np.array_equal(got, bs.band_to_strips(torch.from_numpy(band), b).numpy())


# ------------------------------------------------------- the plain chases


@pytest.mark.parametrize("n,b", [(37, 4), (20, 16), (2, 3)])
def test_band_to_tridiag_matches_jax(dtype, n, b):
    band = _band(n, b, dtype)
    got = b2t.band_to_tridiag(torch.from_numpy(band), b)
    _assert_stage2(got, jb2t.band_to_tridiag(jnp.asarray(band), b), _bound(dtype, n, band))


@pytest.mark.parametrize("n,b", [(37, 4), (41, 8), (20, 16)])
def test_band_to_tridiag_pipelined_matches_jax(dtype, n, b):
    band = _band(n, b, dtype, seed=1)
    got = b2t.band_to_tridiag_pipelined(torch.from_numpy(band), b)
    want = jb2t.band_to_tridiag_pipelined(jnp.asarray(band), b)
    _assert_stage2(got, want, _bound(dtype, n, band))


# the chunk at sweep 40 runs past the last sweep (47): its tail rows stay zero
@pytest.mark.parametrize("n,b,lo,chunk", [(37, 4, 0, None), (50, 8, 40, 16)])
def test_band_to_tridiag_strips_matches_jax(dtype, n, b, lo, chunk):
    band = _band(n, b, dtype, seed=2)
    strips = torch.from_numpy(np.array(jbs.band_to_strips(jnp.asarray(band), b)))
    before = strips.clone()
    got = bs.band_to_tridiag_strips(strips, n, b, sweep_lo=lo, sweep_chunk=chunk)
    want = jbs.band_to_tridiag_strips(jnp.asarray(strips.numpy()), n, b, lo, chunk)
    _assert_stage2(got, want, _bound(dtype, n, band))
    assert torch.equal(strips, before)          # the caller's strips are not written


# ------------------------------- K3: the plain version against Pallas K3


@pytest.mark.parametrize("n,b,dtype", [
    (50, 8, np.dtype("float32")),
    # interpret-mode replays cost 9-15 s each: one f32 case is the fast
    # lane's representative, as in tests/test_band_strips.py
    pytest.param(50, 8, np.dtype("complex64"), marks=pytest.mark.slow),
    pytest.param(200, 160, np.dtype("float32"), marks=pytest.mark.slow),
])
def test_k3_plain_matches_pallas_interpret(n, b, dtype):
    from jax.experimental.pallas import tpu as pltpu
    from dlaf_tpu.ops.pallas.band2tridiag import band_to_tridiag_strips_pallas
    band = _band(n, b, dtype, seed=4)
    jstrips = jbs.band_to_strips(jnp.asarray(band), b)
    with pltpu.force_tpu_interpret_mode():
        want = band_to_tridiag_strips_pallas(jstrips, n, b)
    before = kb2t.band_to_tridiag_strips_kernel.launches
    got = kb2t.band_to_tridiag_strips_kernel(torch.from_numpy(np.array(jstrips)), n, b)
    assert kb2t.band_to_tridiag_strips_kernel.launches == before   # CPU: plain version
    _assert_stage2(got, want, _bound(dtype, n, band))


def test_chaser_feasible():
    assert kb2t.chaser_feasible(8, torch.float32)
    assert kb2t.chaser_feasible(384, torch.complex64)
    assert not kb2t.chaser_feasible(7, torch.float32)
    assert not kb2t.chaser_feasible(385, torch.float32)
    assert not kb2t.chaser_feasible(128, torch.float64)
    assert not kb2t.chaser_feasible(128, torch.complex128)


# -------------------------------------------------------------- dispatch


@pytest.fixture()
def reset_tune():
    yield
    dtt.reset_tune_parameters()
    dlaf_tpu.tune.reset_tune_parameters()


@pytest.mark.parametrize("kind", ["auto", "strips", "pipelined", "sequential"])
def test_auto_routes_on_cpu(kind, reset_tune):
    n, b = 30, 8
    band = _band(n, b, np.float32, seed=5)
    dtt.set_tune_parameters(band_to_tridiag_kernel=kind)
    before = kb2t.band_to_tridiag_strips_kernel.launches
    got = b2t.band_to_tridiag_auto(torch.from_numpy(band), b)
    assert kb2t.band_to_tridiag_strips_kernel.launches == before
    _assert_stage2(got, jb2t.band_to_tridiag(jnp.asarray(band), b),
                   _bound(np.float32, n, band))


def test_kernel_route_on_cpu_raises_as_pallas_does(reset_tune):
    band = _band(30, 8, np.float32)
    dlaf_tpu.set_tune_parameters(band_to_tridiag_kernel="pallas")
    with pytest.raises(ValueError, match="pallas"):
        jb2t.band_to_tridiag_auto(jnp.asarray(band), 8)
    dtt.set_tune_parameters(band_to_tridiag_kernel="kernel")
    with pytest.raises(ValueError, match="kernel"):
        b2t.band_to_tridiag_auto(torch.from_numpy(band), 8)


@pytest.fixture()
def fake_cuda(monkeypatch):
    """Every tensor looks like a CUDA tensor; the kernel library cannot load."""
    monkeypatch.setattr(_build, "on_cuda", lambda t: True)

    def no_library(name):
        raise RuntimeError(f"cannot build {name}")

    monkeypatch.setattr(_build, "library", no_library)


def test_cuda_f32_launches_or_raises(fake_cuda, reset_tune):
    """A CUDA f32 band goes to K3; when K3 cannot run, the error surfaces:
    nothing falls back to a plain route."""
    band = torch.from_numpy(_band(30, 8, np.float32))
    with pytest.raises(RuntimeError, match="cannot build band2tridiag"):
        b2t.band_to_tridiag_auto(band, 8)
    dtt.set_tune_parameters(band_to_tridiag_kernel="kernel")
    with pytest.raises(ValueError, match="kernel"):
        b2t.band_to_tridiag_auto(band.double(), 8)


def test_cuda_f64_takes_the_plain_strip_chase(fake_cuda, monkeypatch):
    calls = []
    monkeypatch.setattr(b2t, "band_to_tridiag_strips",
                        lambda s, n, b: calls.append(s.dtype) or bs.band_to_tridiag_strips(s, n, b))
    band = _band(30, 8, np.float64)
    got = b2t.band_to_tridiag_auto(torch.from_numpy(band), 8)
    assert calls == [torch.float64]
    _assert_stage2(got, jb2t.band_to_tridiag(jnp.asarray(band), 8), _bound(np.float64, 30, band))


@pytest.mark.parametrize("strips,n,b,exc,msg", [
    (torch.zeros(13, 8, 40, dtype=torch.float64), 50, 8, ValueError, "f32/complex64"),
    (torch.zeros(13, 4, 20), 50, 4, ValueError, "8 <= b"),
    (torch.zeros(9, 8, 40), 50, 8, ValueError, "do not hold"),
    (torch.zeros(13, 40, 8).mT, 50, 8, ValueError, "contiguous"),
    (torch.zeros(4, 8, 40), 2, 8, ValueError, "n >= 3"),
])
def test_cuda_kernel_checks(fake_cuda, strips, n, b, exc, msg):
    with pytest.raises(exc, match=msg):
        kb2t.band_to_tridiag_strips_kernel(strips, n, b)


@pytest.mark.parametrize("n,b,dtype", [(50, 4, torch.float32), (50, 8, torch.float64),
                                       (2, 8, torch.float32)])
def test_chase_plan_refuses_what_the_kernel_does_not_take(fake_cuda, n, b, dtype):
    with pytest.raises(ValueError, match="no K3 launch"):
        kb2t.chase_plan(n, b, dtype)


# ------------------------------------------------------- on the card only


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_chase_plan_cuda(dtype):
    """The grid covers every lane where they fit, and stays at the card's
    co-resident blocks where they do not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels run only on the card")
    assert kb2t.chase_plan(1024, 128, dtype) == (3, 3)
    lanes, grid = kb2t.chase_plan(1 << 20, 8, dtype)
    assert lanes == (-(-((1 << 20) - 1) // 8) - 1) // 3 + 1 and 1 <= grid < lanes


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_k3_cuda(dtype):
    """K3 on the card against its plain version: d and |e| entry by entry
    (the signs of e and the reflectors may differ where a reflector's head
    is near 0; chip_smoke.py's k3 phase says why), and the tridiagonal's
    eigenvalues against the band's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels run only on the card")
    n, b = 300, 16
    band = _band(n, b, np.dtype(str(dtype).replace("torch.", "")), seed=6)
    strips = bs.band_to_strips(torch.from_numpy(band), b)
    d0, e0, _, _ = bs.band_to_tridiag_strips(strips, n, b)
    before = kb2t.band_to_tridiag_strips_kernel.launches
    d, e, _, _ = (x.cpu() for x in kb2t.band_to_tridiag_strips_kernel(strips.cuda(), n, b))
    assert kb2t.band_to_tridiag_strips_kernel.launches == before + 1
    bound = _bound(band.dtype, n, band)
    assert float((d - d0).abs().max()) <= bound
    assert float((e.abs() - e0.abs()).abs().max()) <= bound
    t = np.diag(d.double().numpy()) + np.diag(e.abs().double().numpy(), 1) + \
        np.diag(e.abs().double().numpy(), -1)
    assert np.abs(np.linalg.eigvalsh(t) - np.linalg.eigvalsh(band.astype(np.complex128))).max() <= bound
