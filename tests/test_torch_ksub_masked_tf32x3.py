"""K6's arithmetic on the CPU: the masked three-pass TF32 split against K6's bound.

K6 is the masked instantiation of K2's tensor-core kernel
(``dlaf_tpu_torch/csrc/ksub_tf32x3.cu``): C - op(X) Y where
grow[i] >= gcol[j], each f32 operand split as hi = tf32(v), lo = tf32(v -
hi) and the product summed as hi*hi + lo*hi + hi*lo. The card is not here,
so these tests hold the plain PyTorch emulation of that arithmetic
(``ksub_matmul_masked_split_ref``) to K6's error bound on the card,

    max|got - want| <= eps32 (2 k max|x| max|y| + max|c|),

against the f64 plain version (``ksub_matmul_masked_ref`` in f64), at a
distributed chunk cut to (960, 192, 2048) (the heaviest chunk's k) on
numpy-seeded inputs uniform in [-1, 1], as the card's checks draw them: the
lower staircase pattern, the upper pattern on negated indices, and the
panel step's sentinel columns. Three terms hold the bound, one term (plain
TF32) and two terms do not, every split keeps the entries outside the mask
bit for bit, and three terms land no farther from f64 than the JAX
package's Pallas kernel (three bf16 passes, in interpret mode) on the same
inputs; the CPU route of ``ksub_matmul_masked`` lies within that kernel's
bf16_3x tolerance (tests/test_pallas_kernels.py) of it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlaf_tpu.ops.pallas.trailing import ksub_matmul_masked as jax_ksub_masked
from dlaf_tpu_torch.ops.kernels import trailing as ktrail

EPS32 = float(np.finfo(np.float32).eps)
M, N, K = 960, 192, 2048
SENTINEL = 2**30
# the bf16_3x tolerance of tests/test_pallas_kernels.py:136 at this k
PALLAS_BOUND = 64 * K * EPS32 * 16
CASES = ["lower", "upper", "sentinel"]


def _inputs(case, x_k_major=False):
    rng = np.random.default_rng(CASES.index(case) + (10 if x_k_major else 0))
    c = rng.uniform(-1, 1, (M, N)).astype(np.float32)
    x = rng.uniform(-1, 1, (K, M) if x_k_major else (M, K)).astype(np.float32)
    y = rng.uniform(-1, 1, (K, N)).astype(np.float32)
    rows, cols = np.arange(M), np.arange(N)
    if case == "lower":       # a staircase chunk: rows from the chunk's diagonal tile on
        gr, gc = rows + 1024, cols + 1024
    elif case == "upper":     # i <= j as gr >= gc on negated vectors
        gr, gc = -(rows + 64), -(cols * 5)
    else:                     # the panel step: columns past the panel carry the sentinel
        gr, gc = rows + 256, np.where(cols < 128, cols + 512, SENTINEL)
    return c, x, y, gr[:, None].astype(np.int32), gc[None, :].astype(np.int32)


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _want(c, x, y, gr, gc, x_k_major=False):
    """The plain version in f64."""
    c, x, y, gr, gc = _torch(c, x, y, gr, gc)
    return ktrail.ksub_matmul_masked_ref(c.double(), x.double(), y.double(), gr, gc,
                                         x_k_major).numpy()


def _bound(c, x, y):
    """K6's bound (chip_smoke.py _k6_case, K2's): one f32 accumulator walks
    k terms, each rounding error at most eps32 times the running sum."""
    return EPS32 * (2 * K * np.abs(x).max() * np.abs(y).max() + np.abs(c).max())


def _split(c, x, y, gr, gc, terms, x_k_major=False):
    return ktrail.ksub_matmul_masked_split_ref(*_torch(c, x, y, gr, gc), x_k_major,
                                               terms=terms).numpy()


@pytest.mark.parametrize("case", CASES)
def test_masked_three_term_split_holds_k6_bound(case):
    c, x, y, gr, gc = _inputs(case)
    keep = gr >= gc
    assert 0 < keep.mean() < 1     # each pattern has kept and masked entries
    err = np.abs(_split(c, x, y, gr, gc, 3) - _want(c, x, y, gr, gc)).max()
    assert err <= _bound(c, x, y), err


@pytest.mark.parametrize("terms", [1, 2])
@pytest.mark.parametrize("case", CASES)
def test_masked_one_and_two_term_splits_fail_k6_bound(case, terms):
    """One term (plain TF32) or two (without hi*lo) leave a 2^-11 relative
    error in every product; over k = 2048 that lands above the bound's
    2 k eps32, so K6's gate on the card can tell them from f32."""
    c, x, y, gr, gc = _inputs(case)
    err = np.abs(_split(c, x, y, gr, gc, terms) - _want(c, x, y, gr, gc)).max()
    assert err > _bound(c, x, y), err


@pytest.mark.parametrize("terms", [1, 2, 3])
@pytest.mark.parametrize("case", CASES)
def test_masked_split_keeps_outside_bit_equal(case, terms):
    c, x, y, gr, gc = _inputs(case)
    out = _split(c, x, y, gr, gc, terms)
    outside = ~np.broadcast_to(gr >= gc, c.shape)
    np.testing.assert_array_equal(out.view(np.int32)[outside], c.view(np.int32)[outside])


@pytest.mark.parametrize("x_k_major", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_masked_split_against_the_pallas_kernel(case, x_k_major):
    """The port against the reference on the same inputs: the three-term
    split is no farther from f64 than the Pallas kernel, the CPU route of
    ``ksub_matmul_masked`` lies within the Pallas kernel's bf16_3x
    tolerance of it, and both keep the entries outside the mask bit for
    bit."""
    c, x, y, gr, gc = _inputs(case, x_k_major)
    ref = np.asarray(jax_ksub_masked(jnp.asarray(c), jnp.asarray(x), jnp.asarray(y),
                                     jnp.asarray(gr), jnp.asarray(gc), interpret=True,
                                     x_k_major=x_k_major))
    want = _want(c, x, y, gr, gc, x_k_major)
    split_err = np.abs(_split(c, x, y, gr, gc, 3, x_k_major) - want).max()
    assert split_err <= np.abs(ref - want).max()
    tc = torch.from_numpy(c.copy())
    ktrail.ksub_matmul_masked(tc, *_torch(x, y, gr, gc), x_k_major=x_k_major)
    assert np.abs(tc.numpy() - ref).max() <= PALLAS_BOUND
    outside = ~np.broadcast_to(gr >= gc, c.shape)
    for got in (ref, tc.numpy()):
        np.testing.assert_array_equal(got.view(np.int32)[outside], c.view(np.int32)[outside])
