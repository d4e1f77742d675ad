"""The port's kernel modules against the Pallas kernels they replace.

On the CPU each wrapper runs its kernel's plain version; those are held
against the Pallas kernels run in interpret mode (as
tests/test_pallas_kernels.py runs them). A CUDA tensor must launch the
kernel or raise: the dispatch tests fake the device probe and check that
nothing falls back. The cases that need a CUDA card skip here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlaf_tpu.ops.pallas.potrf import potrf_tile as jax_potrf_tile
from dlaf_tpu.ops.pallas.trailing import ksub_matmul as jax_ksub_matmul
from dlaf_tpu_torch.ops import leaf
from dlaf_tpu_torch.ops.kernels import _build
from dlaf_tpu_torch.ops.kernels import potrf as kpotrf
from dlaf_tpu_torch.ops.kernels import trailing as ktrail

from conftest import tol


@pytest.fixture()
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def patched(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", patched)
    yield


def _spd(rng, n):
    r = rng.uniform(-1, 1, (n, n))
    return ((r + r.T) / 2 + n * np.eye(n)).astype(np.float32)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels run only on the card")


# ------------------------------------------------------------------- K1


@pytest.mark.parametrize("nb", [64, 128, 256])
@pytest.mark.parametrize("upper", [False, True])
def test_potrf_tile_plain_matches_pallas(nb, upper, interpret_pallas):
    rng = np.random.default_rng(nb)
    a = _spd(rng, nb)
    # the other triangle holds junk: neither version may read it
    junk = np.where(np.tri(nb, k=-1, dtype=bool).T if not upper else
                    np.tri(nb, k=-1, dtype=bool), 1e3, 0).astype(np.float32)
    a = a + junk
    got = kpotrf.potrf_tile(torch.from_numpy(a), upper=upper).numpy()
    want = np.asarray(jax_potrf_tile(jnp.asarray(a), upper=upper))
    assert np.abs(got - want).max() <= tol(np.float32, nb) * np.abs(want).max()
    other = np.tril(got, -1) if upper else np.triu(got, 1)
    assert np.abs(other).max() == 0.0


def test_potrf_tile_plain_nan_on_non_spd():
    a = _spd(np.random.default_rng(3), 64)
    a[40, 40] = -5.0
    for upper in (False, True):
        f = kpotrf.potrf_tile(torch.from_numpy(a), upper=upper).numpy()
        tri = np.triu(f) if upper else np.tril(f)
        mask = np.triu(np.ones_like(f, bool)) if upper else np.tril(np.ones_like(f, bool))
        assert np.isnan(tri[mask]).all()
        assert not np.isnan(f[~mask]).any()


def test_potrf_tile_plain_bf16_rounds_the_f32_factor():
    a = torch.from_numpy(_spd(np.random.default_rng(4), 64)).to(torch.bfloat16)
    got = kpotrf.potrf_tile(a)
    assert got.dtype == torch.bfloat16
    want = kpotrf.potrf_tile(a.float()).to(torch.bfloat16)
    assert torch.equal(got, want)


def _f64_factor(a):
    return torch.linalg.cholesky(torch.from_numpy(a).double()).mT


def test_factor_deviation_passes_sound_factors():
    a = _spd(np.random.default_rng(5), 256)
    want = _f64_factor(a)
    got = kpotrf.potrf_tile(torch.from_numpy(a), upper=True)
    assert kpotrf.factor_deviation(got, want, 32) <= 1.0
    assert kpotrf.factor_deviation(got.to(torch.bfloat16), got, 32, bf16=True) <= 1.0


@pytest.mark.parametrize("bf16", [False, True])
def test_factor_deviation_rejects_a_small_off_diagonal_fault(bf16):
    """An off-diagonal entry moved by 0.1% of itself (f32), or by two bf16
    ulps, is outside the tolerance, although a bound scaled by the largest
    entry of the factor (its diagonal) would pass either move."""
    a = _spd(np.random.default_rng(6), 128)
    want = kpotrf.potrf_tile(torch.from_numpy(a), upper=True)
    got = want.to(torch.bfloat16) if bf16 else want.clone()
    j = 1 + int(want[0, 1:].abs().argmax())
    v = got[0, j].float()
    if bf16:
        _, e = torch.frexp(v)
        got[0, j] = v + torch.copysign(torch.ldexp(torch.tensor(2.0), e - 8), v)
    else:
        got[0, j] = 1.001 * v
    scaled = 4 * 128 * 2.0**-23 + (2 * 2.0**-7 if bf16 else 0)
    assert float((got.float() - want).abs().max()) < scaled * float(want.max())
    assert kpotrf.factor_deviation(got, want, 32, bf16=bf16) > 1.0
    got[5, 5] = float("nan")
    assert np.isnan(kpotrf.factor_deviation(got, want, 32, bf16=bf16))


# ------------------------------------------------------------------- K2


@pytest.mark.parametrize("shape", [(128, 128, 128), (256, 384, 512),
                                   (512, 256, 1024)])
def test_ksub_plain_matches_pallas(shape):
    m, n, k = shape
    rng = np.random.default_rng(m + n + k)
    c = rng.standard_normal((m, n)).astype(np.float32)
    x = rng.standard_normal((k, m)).astype(np.float32)
    y = rng.standard_normal((k, n)).astype(np.float32)
    tc = torch.from_numpy(c.copy())
    out = ktrail.ksub_matmul(tc, torch.from_numpy(x), torch.from_numpy(y))
    assert out is tc    # written in place
    want = np.asarray(jax_ksub_matmul(jnp.asarray(c), jnp.asarray(x), jnp.asarray(y),
                                      interpret=True))
    # the Pallas kernel's bf16_3x and the plain f32 product differ by the
    # bf16_3x error bound of tests/test_pallas_kernels.py
    bound = 32 * k * np.finfo(np.float32).eps * np.abs(x).max() * np.abs(y).max()
    assert np.abs(out.numpy() - want).max() <= bound


def test_ksub_plain_matches_pallas_nn():
    m, n, k = 256, 256, 384
    rng = np.random.default_rng(42)
    c = rng.standard_normal((m, n)).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    y = rng.standard_normal((k, n)).astype(np.float32)
    out = ktrail.ksub_matmul(torch.from_numpy(c.copy()), torch.from_numpy(x),
                             torch.from_numpy(y), x_k_major=False).numpy()
    want = np.asarray(jax_ksub_matmul(jnp.asarray(c), jnp.asarray(x), jnp.asarray(y),
                                      interpret=True, x_k_major=False))
    bound = 64 * k * np.finfo(np.float32).eps * 16
    assert np.abs(out - want).max() <= bound


def test_ksub_strided_views_in_place():
    """Row-strided views into one buffer, as _herk_inplace passes them."""
    rng = np.random.default_rng(8)
    buf = torch.from_numpy(rng.standard_normal((96, 96)).astype(np.float32))
    ref = buf.clone()
    c, x, y = buf[:32, 40:90], buf[40:72, :32], buf[40:72, 40:90]
    ktrail.ksub_matmul(c, x, y)
    ref[:32, 40:90] -= ref[40:72, :32].T @ ref[40:72, 40:90]
    assert torch.allclose(buf, ref, rtol=0, atol=tol(np.float32, 32) * 8)


def test_ksub_rejects_bad_shapes():
    c, x, y = torch.zeros(4, 5), torch.zeros(3, 4), torch.zeros(2, 5)
    with pytest.raises(ValueError, match="shapes"):
        ktrail.ksub_matmul(c, x, y)


# ------------------------------------------- dispatch: raise, never fall back


@pytest.fixture()
def fake_cuda(monkeypatch):
    """Every tensor looks like a CUDA tensor; the kernel library cannot load."""
    monkeypatch.setattr(_build, "on_cuda", lambda t: True)

    def no_library(name):
        raise RuntimeError(f"cannot build {name}")

    monkeypatch.setattr(_build, "library", no_library)


def test_cuda_tile_of_non_kernel_dtype_raises(fake_cuda):
    with pytest.raises(TypeError, match="f32/bf16"):
        kpotrf.potrf_tile(torch.eye(64, dtype=torch.float64))


@pytest.mark.parametrize("a,msg", [(torch.zeros(64, 32), "square"),
                                   (torch.zeros(60, 60), "nb % 8"),
                                   (torch.zeros(64, 64).T, "unit column stride")])
def test_cuda_tile_shape_checks(fake_cuda, a, msg):
    with pytest.raises(ValueError, match=msg):
        kpotrf.potrf_tile(a)


def test_cuda_kernel_failure_propagates(fake_cuda):
    a = torch.eye(64)
    with pytest.raises(RuntimeError, match="cannot build potrf_tile"):
        leaf.potrf_leaf(a)
    with pytest.raises(RuntimeError, match="cannot build ksub"):
        ktrail.ksub_matmul(torch.zeros(8, 8), torch.zeros(8, 8), torch.zeros(8, 8))


def test_cuda_ksub_checks(fake_cuda):
    z = torch.zeros(8, 8)
    with pytest.raises(TypeError, match="f32"):
        ktrail.ksub_matmul(z.double(), z.double(), z.double())
    with pytest.raises(ValueError, match="unit column stride"):
        ktrail.ksub_matmul(z, z.T, z)


def test_device_probe():
    assert _build.on_cuda(torch.zeros(1)) is False
    with pytest.raises(ValueError, match="no route"):
        _build.on_cuda(torch.zeros(1, device="meta"))


def test_leaf_route_by_dtype(monkeypatch):
    calls = []
    monkeypatch.setattr(leaf, "potrf_tile", lambda a, upper: calls.append(a.dtype) or a)
    for dtype in (torch.float32, torch.bfloat16, torch.float64, torch.complex64):
        leaf.potrf_leaf(torch.eye(8, dtype=dtype))
    assert calls == [torch.float32, torch.bfloat16]
    leaf.set_leaf_backend("torch")
    try:
        leaf.potrf_leaf(torch.eye(8))
    finally:
        leaf.set_leaf_backend(None)
    assert len(calls) == 2
    with pytest.raises(ValueError):
        leaf.set_leaf_backend("pallas")


# ------------------------------------------------------- on the card only


@pytest.mark.parametrize("nb", [64, 256, 512])
@pytest.mark.parametrize("upper", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_potrf_tile_cuda(nb, upper, dtype):
    _need_cuda()
    a = torch.from_numpy(_spd(np.random.default_rng(nb), nb)).cuda().to(getattr(torch, dtype))
    before = kpotrf.potrf_tile.launches
    got = kpotrf.potrf_tile(a, upper=upper)
    assert kpotrf.potrf_tile.launches == before + 1
    bf16 = dtype == "bfloat16"
    want = kpotrf.potrf_tile_ref(a.float() if bf16 else a, upper=upper)
    assert kpotrf.factor_deviation(got, want, 32, bf16=bf16) <= 1.0


@pytest.mark.parametrize("x_k_major", [True, False])
def test_ksub_cuda(x_k_major):
    _need_cuda()
    m, n, k = 1000, 777, 1234
    g = torch.Generator(device="cuda").manual_seed(0)
    c = torch.randn(m, n, device="cuda", generator=g)
    x = torch.randn((k, m) if x_k_major else (m, k), device="cuda", generator=g)
    y = torch.randn(k, n, device="cuda", generator=g)
    want = ktrail.ksub_matmul_ref(c.double(), x.double(), y.double(), x_k_major)
    got = ktrail.ksub_matmul(c.clone(), x, y, x_k_major=x_k_major)
    bound = np.finfo(np.float32).eps * (2 * k * float(x.abs().max() * y.abs().max())
                                        + float(c.abs().max()))
    assert float((got.double() - want).abs().max()) <= bound


def test_potrf_tile_cuda_oversize_nb_raises():
    """A 32-row slab of nb = 1816 does not fit in one block's shared memory
    on an H100: the wrapper refuses it before a launch; nb = 1808 runs."""
    _need_cuda()
    a = torch.from_numpy(_spd(np.random.default_rng(9), 1816)).cuda()
    assert torch.isfinite(kpotrf.potrf_tile(a[:1808, :1808])).all()
    with pytest.raises(ValueError, match="nb <= 1808"):
        kpotrf.potrf_tile(a)
