"""K2's arithmetic on the CPU: the three-pass TF32 split against K2's bound.

K2 (``dlaf_tpu_torch/csrc/ksub_tf32x3.cu``) runs C - op(X) Y on the
tensor cores with each f32 operand split as hi = tf32(v), lo = tf32(v - hi)
and the product summed as hi*hi + lo*hi + hi*lo. The card is not here, so
these tests hold the plain PyTorch emulation of that split
(``ksub_matmul_split_ref``) to K2's error bound on the card,

    max|got - want| <= eps32 (2 k max|x| max|y| + max|c|),

against an f64 product, on numpy-seeded inputs in both layouts: three
terms hold it at every depth, one term (plain TF32) and two terms do not,
and three terms land no farther from f64 than the JAX package's Pallas
kernel (three bf16 passes, run in interpret mode) on the same inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlaf_tpu.ops.pallas.trailing import ksub_matmul as jax_ksub_matmul
from dlaf_tpu_torch.ops.kernels import trailing as ktrail

EPS32 = float(np.finfo(np.float32).eps)
M, N = 64, 48
DEPTHS = [64, 1024, 16384]


def _inputs(k, x_k_major):
    rng = np.random.default_rng(k + (7 if x_k_major else 0))
    c = rng.uniform(-1, 1, (M, N)).astype(np.float32)
    x = rng.uniform(-1, 1, (k, M) if x_k_major else (M, k)).astype(np.float32)
    y = rng.uniform(-1, 1, (k, N)).astype(np.float32)
    return c, x, y


def _bound(c, x, y, k):
    """K2's bound (chip_smoke.py phase_k2): one f32 accumulator walks k
    terms, each rounding error at most eps32 times the running sum."""
    return EPS32 * (2 * k * np.abs(x).max() * np.abs(y).max() + np.abs(c).max())


def _err(got, c, x, y, x_k_major):
    xd = x.astype(np.float64)
    want = c.astype(np.float64) - (xd.T if x_k_major else xd) @ y.astype(np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max())


def _split_err(c, x, y, x_k_major, terms):
    got = ktrail.ksub_matmul_split_ref(torch.from_numpy(c), torch.from_numpy(x),
                                       torch.from_numpy(y), x_k_major, terms=terms)
    return _err(got.numpy(), c, x, y, x_k_major)


def test_tf32_round_is_round_to_nearest_ties_away():
    """The emulation rounds as cvt.rna.tf32.f32: 10 explicit mantissa bits,
    halfway cases away from zero, the low 13 bits cleared."""
    ulp = 2.0 ** -10
    v = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp / 4, 1 + 3 * ulp / 4, -(1 + ulp / 2),
                      3.0, 2.0 ** -130, float("inf"), -0.0], dtype=torch.float32)
    want = [1.0, 1 + ulp, 1.0, 1 + ulp, -(1 + ulp), 3.0, 2.0 ** -130, float("inf"), -0.0]
    got = ktrail.tf32_round(v)
    assert got.tolist() == want
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()


def test_split_hi_lo_is_exact_to_2_pow_22():
    """x - hi is exact in f32, and hi + lo leaves at most 2^-22 |x|: hi keeps
    11 significant bits and lo the next 11, each rounded to nearest."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(100000).astype(np.float32))
    hi = ktrail.tf32_round(x)
    lo = ktrail.tf32_round(x - hi)
    xd, hd, ld = x.double(), hi.double(), lo.double()
    assert torch.equal((x - hi).double(), xd - hd)
    assert bool(((xd - hd - ld).abs() <= 2.0 ** -22 * xd.abs()).all())
    assert bool(((xd - hd).abs() <= 2.0 ** -11 * xd.abs()).all())


@pytest.mark.parametrize("k", DEPTHS)
@pytest.mark.parametrize("x_k_major", [True, False])
def test_three_term_split_holds_k2_bound(k, x_k_major):
    """Three terms: per product the dropped lo*lo and the rounding of lo
    leave ~2^-21 |x||y|, f32's own level, so the whole error stays under
    K2's bound at every depth (these inputs read 0.015-0.25 of it)."""
    c, x, y = _inputs(k, x_k_major)
    assert _split_err(c, x, y, x_k_major, 3) <= _bound(c, x, y, k)


@pytest.mark.parametrize("terms", [1, 2])
@pytest.mark.parametrize("k", DEPTHS)
@pytest.mark.parametrize("x_k_major", [True, False])
def test_one_and_two_term_splits_fail_k2_bound(terms, k, x_k_major):
    """One term (plain TF32) or two (hi*hi + lo*hi, without hi*lo) leave a
    2^-11 relative error in every product; summed over k with random signs
    that grows like sqrt(k) 2^-11, above the bound's 2 k eps32 up to
    k = 16384 (these inputs read 7x the bound or more)."""
    c, x, y = _inputs(k, x_k_major)
    assert _split_err(c, x, y, x_k_major, terms) > _bound(c, x, y, k)


@pytest.mark.parametrize("k", DEPTHS)
@pytest.mark.parametrize("x_k_major", [True, False])
def test_three_term_split_no_worse_than_the_pallas_kernel(k, x_k_major):
    """The port's scheme against the reference's: the JAX Pallas kernel
    splits in bf16 (8 significant bits a part, so ~2^-16 per product), the
    port in TF32 (11 bits a part); on the same inputs the port's error is
    no larger than the Pallas kernel's (these inputs: 0.06-0.12 of it; the
    Pallas kernel itself reads 0.15-2.5 of K2's bound)."""
    c, x, y = _inputs(k, x_k_major)
    ref = jax_ksub_matmul(jnp.asarray(c), jnp.asarray(x), jnp.asarray(y), interpret=True,
                          x_k_major=x_k_major)
    assert _split_err(c, x, y, x_k_major, 3) <= _err(np.asarray(ref), c, x, y, x_k_major)


def test_split_ref_terms_checked():
    z = torch.zeros(2, 2)
    with pytest.raises(ValueError, match="terms"):
        ktrail.ksub_matmul_split_ref(z, z, z, terms=4)
