"""K6's pipelined route (``csrc/ksub_tf32x3.cu``,
``ksub_tf32x3_kernel<true>``): the masked 3xTF32 trailing update on a TMA ring with
warp-specialized wgmma, taken by the launches with X (m, k), 16-byte aligned
operands and no k split.

On the card each case is held to K6's bound against the f64 plain version
(``ksub_matmul_masked_ref``), bit-equal outside the mask, and counted by
``ksub_matmul_masked.pipelined`` (+1 on the pipelined route, +0 on the
4-byte and split-k routes). The cases skip without a CUDA device: the
kernel runs only on the card. Run them there with

    python -m pytest -c /dev/null --rootdir . --noconftest tests/test_torch_k6_pipeline.py

(``tests/conftest.py`` imports JAX, which the card's machine does not have).
The tests of the name that ``k6_roofline`` reads run on the CPU.
"""
import pytest
import torch

import dlaf_tpu_torch as dt
from dlaf_tpu_torch.matrix import generators as gen
from dlaf_tpu_torch.ops.kernels import trailing as kt
from portbench.metrics.k6_roofline import is_k6

EPS32 = float(torch.finfo(torch.float32).eps)
SENTINEL = 2**30
# the benchmark's cholesky-f32.n40960: n = 40960, nb = 512; its first
# staircase chunks have rows from tile 4 on (m = 38912) and k = 2048
N, NB, M_CELL, K_CELL = 40960, 512, 38912, 2048

# the kernels' names as torch.profiler reported them on an H100 (key_averages
# of a pipelined K6 launch, a split-k K6 launch and a split-k K2 launch)
PIPELINED_NAME = ("void (anonymous namespace)::ksub_tf32x3_kernel<true>(CUtensorMap_st, "
                  "CUtensorMap_st, float*, long long, int, int, int, int const*, int const*)")
K6_SPLIT_NAME = ("void (anonymous namespace)::ksub_tf32x3_kernel<false, true, true, true>(float*, "
                 "long long, float const*, long long, float const*, long long, int, int, int, "
                 "int, int const*, int const*)")
K2_NAME = ("void (anonymous namespace)::ksub_tf32x3_kernel<false, true, true, false>(float*, "
           "long long, float const*, long long, float const*, long long, int, int, int, int, "
           "int const*, int const*)")


@pytest.mark.parametrize("name, k6", [(PIPELINED_NAME, True), (K6_SPLIT_NAME, True),
                                      (K2_NAME, False)])
def test_k6_roofline_reads_the_kernel(name, k6):
    """``k6_roofline`` counts the pipelined kernel's time as K6's, and not K2's."""
    assert is_k6(name) is k6


def test_cpu_route_is_not_pipelined():
    """The plain version on the CPU is no launch of either route."""
    g = torch.Generator().manual_seed(0)
    c, x, y = (torch.randn(s, generator=g) for s in ((64, 48), (64, 32), (32, 48)))
    launches, piped = kt.ksub_matmul_masked.launches, kt.ksub_matmul_masked.pipelined
    kt.ksub_matmul_masked(c, x, y, torch.arange(64)[:, None], torch.arange(48)[None, :],
                          x_k_major=False)
    assert (kt.ksub_matmul_masked.launches, kt.ksub_matmul_masked.pipelined) == (launches, piped)


# ------------------------------------------------------- on the card only

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(gen, *shape):
    return torch.randn(*shape, generator=gen, device="cuda")


def _check(c, x, y, gr, gc, pipelined: bool):
    """K6 on (c, x, y) in place: K6's bound against f64, bit-equal outside
    the mask, a repeat bit-identical, the route counted."""
    c0 = c.clone()
    want = kt.ksub_matmul_masked_ref(c0.double(), x.double(), y.double(), gr, gc, False)
    launches, piped = kt.ksub_matmul_masked.launches, kt.ksub_matmul_masked.pipelined
    kt.ksub_matmul_masked(c, x, y, gr, gc, x_k_major=False)
    got = c.clone()
    c.copy_(c0)
    kt.ksub_matmul_masked(c, x, y, gr, gc, x_k_major=False)
    assert kt.ksub_matmul_masked.launches - launches == 2
    assert kt.ksub_matmul_masked.pipelined - piped == 2 * int(pipelined)
    k = y.shape[0]
    bound = EPS32 * (2 * k * float(x.abs().max()) * float(y.abs().max()) + float(c0.abs().max()))
    err = float((got.double() - want).abs().max())
    assert err <= bound, (err, bound)
    keep = (gr >= gc).expand_as(c)
    bits = lambda t: t.view(torch.int32)  # noqa: E731
    assert torch.equal(torch.where(keep, 0, bits(got)), torch.where(keep, 0, bits(c0)))
    assert torch.equal(bits(got), bits(c))


@pytest.mark.parametrize("n", [512, 1024, 1536, 2048])
def test_cell_chunks(n):
    """The n40960 cell's staircase chunks: rows and columns from tile 4 on,
    views with the cell's leading dimensions; the top tiles are dead or cut
    by the diagonal."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(n)
    idx = torch.arange(N, device=dev, dtype=torch.int32)
    r0 = N - M_CELL
    cbuf = _rand(g, M_CELL, n + 512)
    wide = _rand(g, M_CELL + NB, K_CELL)
    wide_t = _rand(g, K_CELL, N - 4 * NB)
    _check(cbuf[:, 512:], wide[NB:], wide_t[:, :n], idx[r0:, None], idx[None, r0:r0 + n], True)


def test_panel_step_sentinel():
    """The in-panel update at k = 512: the panel's last 512 columns carry
    the sentinel, which no row index reaches."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(1)
    idx = torch.arange(N, device=dev, dtype=torch.int32)
    cols = torch.arange(NB, 4 * NB, device=dev, dtype=torch.int32)
    gc = torch.where(cols < 3 * NB, cols, SENTINEL)[None, :]
    a = _rand(g, 8192, 4 * NB)
    _check(a[:, NB:], _rand(g, 8192, NB), _rand(g, NB, 4 * NB)[:, NB:], idx[:8192, None], gc,
           True)


def test_ragged_m():
    """m not a multiple of 128 (and k not of 32): the last tile's rows and
    steps past the edge are zero-filled, and no row past m is written."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(2)
    m, n, k = 5000, 1024, 2000
    idx = torch.arange(m, device=dev, dtype=torch.int32)
    _check(_rand(g, m, n), _rand(g, m, k), _rand(g, k, n), (idx + 600)[:, None],
           (2 * idx[:n])[None, :], True)


def test_upper_negated():
    """The upper factor's chunk: i <= j as grow >= gcol on negated indices."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(3)
    idx = torch.arange(N, device=dev, dtype=torch.int32)
    rows, t0 = 2048, 4 * NB
    a = _rand(g, rows, N)
    _check(a[:, t0:], _rand(g, rows, K_CELL), _rand(g, K_CELL, N)[:, t0:],
           -idx[t0:t0 + rows, None], -idx[None, t0:], True)


def test_dead_and_live_tiles():
    """Column indices scattered so that dead and live tiles interleave."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(4)
    m, n, k = 4096, 2048, 1024
    rows = torch.arange(m, device=dev, dtype=torch.int32)
    cols = (torch.arange(n, device=dev, dtype=torch.int32) * 7919) % (2 * m)
    _check(_rand(g, m, n), _rand(g, m, k), _rand(g, k, n), rows[:, None], cols[None, :], True)


def test_all_tiles_dead():
    """Every row index below every column index: C comes back bit-unchanged."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(5)
    m = 4096
    idx = torch.arange(m, device=dev, dtype=torch.int32)
    _check(_rand(g, m, m), _rand(g, m, 512), _rand(g, 512, m), idx[:, None],
           (idx + m)[None, :], True)


def test_non_finite_propagates():
    """NaNs in X and in Y (the card's own, 0x7FFFFFFF, and its negation,
    whose rounding carries out of the sign bit) and an infinity in X reach
    every kept entry whose product they enter, as on the route before (a
    product with a non-finite lo is NaN): the non-finite kept entries are
    the f64 plain version's, the finite ones within K6's bound, and nothing
    outside the mask changes."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(7)
    m, n, k = 2048, 1024, 1024
    idx = torch.arange(m, device=dev, dtype=torch.int32)
    c, x, y = _rand(g, m, n), _rand(g, m, k), _rand(g, k, n)
    x.view(torch.int32)[1500, 300] = 0x7FFFFFFF
    x.view(torch.int32)[1600, 10] = -1               # 0xFFFFFFFF
    x[1700, 900] = float("inf")
    y.view(torch.int32)[40, 700] = -1
    y.view(torch.int32)[41, 900] = 0x7FFFFFFF
    gr, gc = (idx + 200)[:, None], idx[None, :n]
    c0 = c.clone()
    want = kt.ksub_matmul_masked_ref(c0.double(), x.double(), y.double(), gr, gc, False)
    piped = kt.ksub_matmul_masked.pipelined
    kt.ksub_matmul_masked(c, x, y, gr, gc, x_k_major=False)
    assert kt.ksub_matmul_masked.pipelined - piped == 1
    keep = (gr >= gc).expand_as(c)
    bad = ~torch.isfinite(want)
    assert int(bad.sum()) > n
    assert torch.equal(~torch.isfinite(c), bad)
    for r in (1500, 1600):
        assert torch.isnan(c[r][keep[r]]).all(), r
    for j in (700, 900):
        assert torch.isnan(c[:, j][keep[:, j]]).all(), j
    bound = EPS32 * (2 * k * float(x[torch.isfinite(x)].abs().max()) *
                     float(y[torch.isfinite(y)].abs().max()) + float(c0.abs().max()))
    assert float((c.double() - want)[~bad].abs().max()) <= bound
    bits = lambda t: t.view(torch.int32)  # noqa: E731
    assert torch.equal(torch.where(keep, 0, bits(c)), torch.where(keep, 0, bits(c0)))


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_cholesky_info_nan_off_leaf_tiles(device):
    """The distributed Cholesky on a 1x1 grid with a NaN pair off the
    diagonal tiles, in tile (5, 1): the panel's NaN row reaches the
    trailing matrix through K6, so a pivot of the NaN's row tile is NaN and
    ``cholesky_info`` reports that tile, on the kernel route as on the
    plain one. On the card n is large enough that the trailing updates
    which carry the NaN take the pipelined route, not split-k."""
    if device == "cuda":
        _card()
    n, nb = (16384, 512) if device == "cuda" else (1024, 64)
    row, col = 5 * nb + nb // 2 + 7, nb + nb // 2 + 3
    g = torch.Generator(device=device).manual_seed(8)
    a = gen.random_hermitian_positive_definite(g, n, torch.float32)
    a[row, col] = a[col, row] = float("nan")
    tile = row // nb
    infos = {}
    try:
        for route in ("kernel", "torch"):
            dt.set_tune_parameters(potrf_trailing_kernel=route)
            piped = kt.ksub_matmul_masked.pipelined
            f, info = dt.cholesky_info(dt.DistMatrix.from_global(a, nb, dt.Grid((1, 1))))
            infos[route] = (int(info), kt.ksub_matmul_masked.pipelined - piped)
            assert torch.isnan(f.to_global()[row]).any(), route
    finally:
        dt.reset_tune_parameters()
    for route, (info, _) in infos.items():
        assert tile * nb < info <= (tile + 1) * nb, (route, info)
    assert (infos["kernel"][1] > 0) == (device == "cuda")


def test_other_routes_not_counted():
    """Unaligned row-strided views take the 4-byte route and a small grid
    the split-k route: neither is counted as pipelined."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(6)
    idx = torch.arange(5000, device=dev, dtype=torch.int32)
    _check(_rand(g, 1000, 782)[:, 5:], _rand(g, 1000, 1237)[:, 3:], _rand(g, 1234, 778)[:, 1:],
           (idx[:1000] + 800)[:, None], idx[None, :777], False)
    _check(_rand(g, 300, 200), _rand(g, 300, 5000), _rand(g, 5000, 200), (2 * idx[:300])[:, None],
           (3 * idx[:200] + 100)[None, :], False)
