"""K6 (``ksub_matmul_masked``) against the Pallas kernel it replaces, and
the overlap check of the K2/K6 wrappers.

On the CPU the wrapper runs K6's plain version; it is held against
``dlaf_tpu.ops.pallas.trailing.ksub_matmul_masked`` in interpret mode, in
both layouts, at the tolerance of tests/test_pallas_kernels.py (the Pallas
kernel's bf16_3x products against f32): the 2x3-grid index pattern, the
sentinel columns of the panel-restricted update, the negated (upper)
vectors, and an all-dead input, which must come back bit-unchanged.
Ragged shapes, which the Pallas kernel refuses, are held to numpy in f64.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlaf_tpu.ops.pallas.trailing import ksub_matmul_masked as jax_ksub_masked
from dlaf_tpu_torch.ops.kernels import _build
from dlaf_tpu_torch.ops.kernels import trailing as ktrail

M, N, K = 256, 384, 256
SENTINEL = 2**30
# the bf16_3x bound of tests/test_pallas_kernels.py:136
BOUND = 64 * K * np.finfo(np.float32).eps * 16


def _operands(seed, x_k_major, m=M, n=N, k=K):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((m, n)).astype(np.float32)
    x = rng.standard_normal((k, m) if x_k_major else (m, k)).astype(np.float32)
    y = rng.standard_normal((k, n)).astype(np.float32)
    return c, x, y


def _indices(case):
    """(grow (M, 1), gcol (1, N)) int32 for each index pattern."""
    rows, cols = np.arange(M), np.arange(N)
    if case == "grid2x3":      # offset + stride of a 2x3 grid shard (test_pallas_kernels.py:128)
        gr, gc = rows * 2 + 128, cols * 3 + 64
    elif case == "sentinel":   # the panel-restricted update: columns past pl_end
        gr, gc = rows + 200, np.where(cols < 200, cols + 100, SENTINEL)
    elif case == "upper":      # i <= j as gr >= gc on negated vectors
        gr, gc = -(rows + 64), -(cols * 2)
    elif case == "dead":       # every row index below every column index
        gr, gc = rows, cols + M
    return gr[:, None].astype(np.int32), gc[None, :].astype(np.int32)


CASES = ["grid2x3", "sentinel", "upper", "dead"]


@pytest.mark.parametrize("x_k_major", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_pallas(case, x_k_major):
    c, x, y = _operands(CASES.index(case), x_k_major)
    gr, gc = _indices(case)
    tc = torch.from_numpy(c.copy())
    out = ktrail.ksub_matmul_masked(tc, torch.from_numpy(x), torch.from_numpy(y),
                                    torch.from_numpy(gr), torch.from_numpy(gc),
                                    x_k_major=x_k_major)
    assert out is tc    # written in place
    want = np.asarray(jax_ksub_masked(jnp.asarray(c), jnp.asarray(x), jnp.asarray(y),
                                      jnp.asarray(gr), jnp.asarray(gc), interpret=True,
                                      x_k_major=x_k_major))
    got = out.numpy()
    assert np.abs(got - want).max() <= BOUND, np.abs(got - want).max()
    keep = gr >= gc
    # entries outside the mask keep C bit for bit, in both packages
    np.testing.assert_array_equal(got[~np.broadcast_to(keep, got.shape)],
                                  c[~np.broadcast_to(keep, c.shape)])
    if case == "dead":
        np.testing.assert_array_equal(got, c)
        np.testing.assert_array_equal(want, c)


@pytest.mark.parametrize("x_k_major", [True, False])
@pytest.mark.parametrize("shape", [(130, 77, 33), (1, 5, 300), (300, 200, 1)])
def test_plain_ragged_against_f64(shape, x_k_major):
    """Ragged shapes (the Pallas kernel takes only multiples of its
    blocks) and row-strided views, against numpy in f64."""
    m, n, k = shape
    c, x, y = _operands(m + n + k, x_k_major, m, n, k)
    gr = (np.arange(m) * 2 + 1)[:, None].astype(np.int32)
    gc = (np.arange(n) * 3)[None, :].astype(np.int32)
    buf = torch.zeros((m, n + 5))
    view = buf[:, 5:]
    view.copy_(torch.from_numpy(c))
    ktrail.ksub_matmul_masked(view, torch.from_numpy(x), torch.from_numpy(y),
                              torch.from_numpy(gr), torch.from_numpy(gc), x_k_major=x_k_major)
    xd = x.astype(np.float64)
    want = np.where(gr >= gc, c - (xd.T if x_k_major else xd) @ y.astype(np.float64), c)
    bound = 2 * k * np.finfo(np.float32).eps * np.abs(x).max() * np.abs(y).max() + \
        np.finfo(np.float32).eps * np.abs(c).max()
    assert np.abs(view.numpy() - want).max() <= bound
    assert float(buf[:, :5].abs().max()) == 0.0     # nothing outside the view


def test_strided_index_vectors():
    """Index vectors may be strided views (column slices of a larger index
    array), as the distributed POTRF's slices are."""
    c, x, y = _operands(9, False, 16, 12, 8)
    rows = torch.arange(32, dtype=torch.int32).reshape(16, 2)[:, :1]
    cols = torch.arange(24, dtype=torch.int32).reshape(1, 24)[:, ::2]
    got = ktrail.ksub_matmul_masked(torch.from_numpy(c.copy()), torch.from_numpy(x),
                                    torch.from_numpy(y), rows, cols, x_k_major=False)
    want = ktrail.ksub_matmul_masked_ref(torch.from_numpy(c), torch.from_numpy(x),
                                         torch.from_numpy(y), rows.contiguous(),
                                         cols.contiguous(), x_k_major=False)
    assert torch.equal(got, want)


def test_rejects_bad_index_shapes():
    c, x, y = torch.zeros(4, 5), torch.zeros(4, 3), torch.zeros(3, 5)
    with pytest.raises(ValueError, match="index shapes"):
        ktrail.ksub_matmul_masked(c, x, y, torch.zeros(5, 1, dtype=torch.int32),
                                  torch.zeros(1, 5, dtype=torch.int32), x_k_major=False)


# ------------------------------------------------ overlap: c must not alias x, y


def test_ksub_refuses_overlapping_operands():
    buf = torch.zeros(64, 64)
    with pytest.raises(ValueError, match="c overlaps x"):
        ktrail.ksub_matmul(buf[:32, :32], buf[16:48, :32], torch.zeros(32, 32))
    with pytest.raises(ValueError, match="c overlaps y"):
        ktrail.ksub_matmul(buf[:32, 32:], torch.zeros(16, 32), buf[16:32, 32:])


def test_ksub_masked_refuses_overlapping_operands():
    buf = torch.zeros(64, 64)
    gr, gc = torch.zeros(32, 1, dtype=torch.int32), torch.zeros(1, 32, dtype=torch.int32)
    with pytest.raises(ValueError, match="c overlaps x"):
        ktrail.ksub_matmul_masked(buf[:32, :32], buf[:32, 32:48], torch.zeros(16, 32),
                                  gr, gc, x_k_major=False)
    with pytest.raises(ValueError, match="c overlaps y"):
        ktrail.ksub_matmul_masked(buf[:32, :32], torch.zeros(32, 16), buf[:16, 8:40],
                                  gr, gc, x_k_major=False)


# ------------------------------------------- dispatch: raise, never fall back


@pytest.fixture()
def fake_cuda(monkeypatch):
    """Every tensor looks like a CUDA tensor; the kernel library cannot load."""
    monkeypatch.setattr(_build, "on_cuda", lambda t: True)

    def no_library(name):
        raise RuntimeError(f"cannot build {name}")

    monkeypatch.setattr(_build, "library", no_library)


def test_cuda_k6_checks(fake_cuda):
    z = torch.zeros(8, 8)
    gr, gc = torch.zeros(8, 1, dtype=torch.int32), torch.zeros(1, 8, dtype=torch.int32)
    with pytest.raises(TypeError, match="f32"):
        ktrail.ksub_matmul_masked(z.double(), z.double(), z.double(), gr, gc)
    with pytest.raises(TypeError, match="int32"):
        ktrail.ksub_matmul_masked(z.clone(), z.clone(), z.clone(), gr.long(), gc)
    with pytest.raises(ValueError, match="unit column stride"):
        ktrail.ksub_matmul_masked(z.clone(), z.T, z.clone(), gr, gc)
    with pytest.raises(RuntimeError, match="cannot build ksub"):
        ktrail.ksub_matmul_masked(z.clone(), z.clone(), z.clone(), gr, gc)


def test_cpu_wrapper_counts_no_launch():
    before = ktrail.ksub_matmul_masked.launches
    c, x, y = (torch.zeros(8, 8) for _ in range(3))
    ktrail.ksub_matmul_masked(c, x, y, torch.zeros(8, 1, dtype=torch.int32),
                              torch.zeros(1, 8, dtype=torch.int32))
    assert ktrail.ksub_matmul_masked.launches == before


# ------------------------------------------------------- on the card only


@pytest.mark.parametrize("x_k_major", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_k6_cuda(case, x_k_major):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels run only on the card")
    c, x, y = (torch.from_numpy(t).cuda() for t in _operands(CASES.index(case), x_k_major))
    gr, gc = (torch.from_numpy(t).cuda() for t in _indices(case))
    before = ktrail.ksub_matmul_masked.launches
    got = ktrail.ksub_matmul_masked(c.clone(), x, y, gr, gc, x_k_major=x_k_major)
    assert ktrail.ksub_matmul_masked.launches == before + 1
    want = ktrail.ksub_matmul_masked_ref(c.double(), x.double(), y.double(), gr, gc, x_k_major)
    keep = (gr >= gc).expand_as(c)
    assert torch.equal(got[~keep], c[~keep])
    bound = np.finfo(np.float32).eps * (2 * K * float(x.abs().max() * y.abs().max())
                                        + float(c.abs().max()))
    assert float((got.double() - want).abs().max()) <= bound
