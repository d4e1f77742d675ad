"""The ScaLAPACK surface's host copies (``api/scalapack.py``): the direct
route and the pinned staging ring.

A host matrix bound for a CUDA device, and a matrix on the card bound for
the host, that span two row blocks of the ring or more are copied block by
block through pinned slots; everything else (``device="cpu"``, small or
non-matrix arrays) takes the direct copy, which on the CPU is a view. On
the CPU the tests hold the block planner and the direct route; the staged
route runs only on the card, where each case holds it bit for bit to the
direct one. Run them there with

    python -m pytest -c /dev/null --rootdir . --noconftest tests/test_torch_surface_staging.py

(``tests/conftest.py`` imports JAX, which the card's machine does not have).
"""
import sys
import threading

import numpy as np
import pytest
import torch

from dlaf_tpu_torch import spans
from dlaf_tpu_torch.api import scalapack as sl
from dlaf_tpu_torch.matrix import generators as gen

META_CUDA = torch.device("cuda", 0)     # a device name: nothing is allocated on it


@pytest.fixture
def ring(monkeypatch):
    """A fresh, empty ring, so that a test sees what it allocates."""
    fresh = sl._StagingRing()
    monkeypatch.setattr(sl, "_RING", fresh)
    return fresh


@pytest.fixture
def recorder():
    spans.disable()
    spans.drain()
    yield spans
    spans.disable()
    spans.drain()


def _copies(recs):
    return [(r.name, r.attrs) for r in recs if r.name in ("surface.to_card", "surface.to_host")]


# ------------------------------------------------------------------ CPU

@pytest.mark.parametrize("rows, row_bytes", [
    (1, 4), (7, 4), (20480, 20480 * 4), (20480, 20480 * 16), (6000, 6000 * 4),
    (1 << 12, sl._BLOCK_BYTES // 8), (1000, sl._BLOCK_BYTES), (3, sl._BLOCK_BYTES + 1)])
def test_row_blocks_cover_every_row_once(rows, row_bytes):
    """Consecutive ranges from 0 to ``rows``, none empty, each within a slot
    (or one row where a row is larger)."""
    blocks = sl._row_blocks(rows, row_bytes)
    covered = [r for r0, r1 in blocks for r in range(r0, r1)]
    assert covered == list(range(rows))
    assert all(r1 > r0 for r0, r1 in blocks)
    assert all((r1 - r0) * row_bytes <= sl._BLOCK_BYTES or r1 - r0 == 1 for r0, r1 in blocks)
    assert all(r1 - r0 == blocks[0][1] for r0, r1 in blocks[:-1])


@pytest.mark.parametrize("shape, dtype, dev, blocks", [
    ((20480, 20480), torch.float32, META_CUDA, 51),
    ((6000, 6000), torch.float32, META_CUDA, 5),
    ((4096, 4096), torch.float32, META_CUDA, 2),
    ((4096, 4096), torch.complex128, META_CUDA, 8),
    ((20480, 20480), torch.float32, torch.device("cpu"), None),
    ((2048, 4096), torch.float32, META_CUDA, None),           # one block
    ((64, 64), torch.float64, META_CUDA, None),
    ((20480 * 20480,), torch.float32, META_CUDA, None),       # not a matrix
    ((4, sl._BLOCK_BYTES), torch.float32, META_CUDA, None),   # a row larger than a slot
])
def test_route_follows_device_and_size(shape, dtype, dev, blocks):
    t = torch.empty(shape, dtype=dtype, device="meta")
    got = sl._staged_blocks(t, dev)
    assert (None if got is None else len(got)) == blocks


def test_route_needs_a_contiguous_matrix():
    t = torch.empty((8192, 8192), device="meta")
    assert sl._staged_blocks(t, META_CUDA) is not None
    assert sl._staged_blocks(t.t(), META_CUDA) is None
    assert sl._staged_blocks(t[:, ::2], META_CUDA) is None


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64, np.complex128])
def test_cpu_copies_are_direct_views_and_pin_nothing(ring, monkeypatch, dtype):
    """On the CPU both copies are views of the caller's memory, whatever the
    size against the blocks; no slot is allocated and nothing is counted."""
    monkeypatch.setattr(sl, "_BLOCK_BYTES", 4096)
    a = np.random.default_rng(0).standard_normal((96, 80)).astype(dtype)
    count = sl.staged_copies
    t = sl._on(a, torch.device("cpu"))
    assert np.shares_memory(t.numpy(), a) and t.dtype == torch.from_numpy(a).dtype
    back = sl._to_host(t)
    assert np.shares_memory(back, a) and np.array_equal(back, a)
    assert ring.slots is None and sl.staged_copies == count


def test_cpu_read_only_and_strided_inputs():
    a = np.random.default_rng(1).standard_normal((64, 96)).astype(np.float32)
    ro = a.copy()
    ro.setflags(write=False)
    assert np.array_equal(sl._on(ro, torch.device("cpu")).numpy(), a)
    strided = np.asfortranarray(a)
    t = sl._on(strided, torch.device("cpu"))
    assert t.is_contiguous() and np.array_equal(t.numpy(), a)


def test_cpu_eigensolver_copies_name_the_route(recorder):
    """``dlaf_pssyevd`` on the CPU: its copies are spans with the direct route."""
    n, nb = 64, 16
    a = gen.random_hermitian(torch.Generator().manual_seed(3), n, torch.float32).numpy()
    ctx = sl.dlaf_create_grid(1, 1)
    try:
        desc = np.array([1, ctx, n, n, nb, nb, 0, 0, n], dtype=np.int64)
        recorder.enable()
        w, z = sl.dlaf_pssyevd("L", n, a, 1, 1, desc, ctx, device="cpu")
        recorder.disable()
    finally:
        sl.dlaf_free_grid(ctx)
    recs, _ = recorder.drain()
    direct = {"route": "direct", "chunks": 1}
    assert _copies(recs) == [("surface.to_card", {"bytes": n * n * 4, **direct}),
                             ("surface.to_host", {"bytes": n * 4, **direct}),
                             ("surface.to_host", {"bytes": n * n * 4, **direct})]
    assert w.shape == (n,) and z.shape == (n, n)


# ------------------------------------------------------- on the card only

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the staging ring copies between pinned host "
                    "memory and the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _bits(x) -> np.ndarray:
    x = np.ascontiguousarray(x)
    return x.view(np.uint8)


def _matrix(shape, dtype, seed):
    """Random entries, a NaN, an infinity and a -0 among them."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        a = a + 1j * rng.standard_normal(shape)
    a = a.astype(dtype)
    a[0, 1], a[-1, -2], a[shape[0] // 2, 0] = np.nan, np.inf, -0.0
    return a


def _round_trip(a, dev, blocks, src=None):
    """``a`` (or ``src``, a CPU tensor of it) to the card and back on both
    routes, bit for bit; the staged copies counted and recorded with their
    route and chunks."""
    count = sl.staged_copies
    spans.enable()
    try:
        t = sl._on(a if src is None else src, dev)
        back = sl._to_host(t)
    finally:
        spans.disable()
    recs, _ = spans.drain()
    want = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    assert torch.equal(t.view(torch.uint8), want.view(torch.uint8))
    assert np.array_equal(_bits(back), _bits(want.cpu().numpy()))
    assert np.array_equal(_bits(back), _bits(a))
    assert sl.staged_copies - count == 2
    staged = {"bytes": a.nbytes, "route": "staged", "chunks": blocks}
    assert _copies(recs) == [("surface.to_card", staged), ("surface.to_host", staged)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64, np.complex128])
def test_staged_round_trip_bit_equal(ring, monkeypatch, dtype):
    """Small slots, so that the blocks wrap round the ring many times; the
    last block is ragged (1000 rows in blocks of 93, 46, 46 and 23)."""
    dev = _card()
    monkeypatch.setattr(sl, "_BLOCK_BYTES", 256 << 10)
    a = _matrix((1000, 700), dtype, 1)
    _round_trip(a, dev, len(sl._row_blocks(1000, 700 * a.itemsize)))
    assert len(ring.slots) == sl._SLOTS


def test_staged_at_the_ring_size(ring):
    """The module's slots: n = 6000 f32 is 5 blocks, the last ragged; the
    ring is allocated once."""
    dev = _card()
    a = _matrix((6000, 6000), np.float32, 2)
    _round_trip(a, dev, 5)
    slots = ring.slots
    assert [s.numel() for s in slots] == [sl._BLOCK_BYTES] * sl._SLOTS
    assert all(s.is_pinned() for s in slots)
    _round_trip(a, dev, 5)
    assert ring.slots is slots


@pytest.mark.parametrize("layout", ["read_only", "fortran", "strided", "cpu_tensor"])
def test_staged_unusual_inputs(ring, monkeypatch, layout):
    dev = _card()
    monkeypatch.setattr(sl, "_BLOCK_BYTES", 128 << 10)
    a = _matrix((700, 1100), np.float32, 3)
    src = None
    if layout == "read_only":
        a.setflags(write=False)
    elif layout == "fortran":
        a = np.asfortranarray(a)
    elif layout == "strided":
        a = _matrix((700, 2200), np.float32, 3)[:, ::2]
    else:
        src = torch.from_numpy(a)
    _round_trip(a, dev, len(sl._row_blocks(700, 1100 * 4)), src)


def test_staged_copies_from_threads(ring, monkeypatch):
    """More threads than cores share the ring, each with its own matrices:
    every round trip bit for bit, every staged copy counted once."""
    dev = _card()
    monkeypatch.setattr(sl, "_BLOCK_BYTES", 64 << 10)
    threads, rounds = 12, 3
    mats = [_matrix((300, 500), np.float32, 10 + k) for k in range(threads)]
    got, errors = {}, []

    def work(k):
        try:
            for r in range(rounds):
                got[k, r] = sl._to_host(sl._on(mats[k], dev))
        except Exception as e:  # read after the join
            errors.append(e)

    count = sl.staged_copies
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool) and not errors, errors
    assert all(np.array_equal(_bits(got[k, r]), _bits(mats[k]))
               for k in range(threads) for r in range(rounds))
    assert sl.staged_copies - count == 2 * threads * rounds


def _pspotrf_both_routes(monkeypatch, dev, uplo, n, a, ia, desc, ctx):
    """dlaf_pspotrf on the staged route (two staged copies) and on the
    direct one."""
    count = sl.staged_copies
    staged = sl.dlaf_pspotrf(uplo, n, a, ia, ia, desc, ctx)
    assert sl.staged_copies - count == 2
    with monkeypatch.context() as m:
        m.setattr(sl, "_staged_blocks", lambda t, d: None)
        direct = sl.dlaf_pspotrf(uplo, n, a, ia, ia, desc, ctx)
    assert sl.staged_copies - count == 2
    return staged, direct


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_pspotrf_staged_equals_direct(monkeypatch, uplo):
    """n = 4096 f32 is two blocks of the ring each way."""
    dev = _card()
    n, nb = 4096, 512
    a = gen.random_hermitian_positive_definite(torch.Generator(device=dev).manual_seed(4), n,
                                               torch.float32).cpu().numpy()
    ctx = sl.dlaf_create_grid(1, 1)
    try:
        desc = np.array([1, ctx, n, n, nb, nb, 0, 0, n], dtype=np.int64)
        staged, direct = _pspotrf_both_routes(monkeypatch, dev, uplo, n, a, 1, desc, ctx)
    finally:
        sl.dlaf_free_grid(ctx)
    assert np.array_equal(_bits(staged), _bits(direct))
    other, k = (np.triu, 1) if uplo == "L" else (np.tril, -1)
    assert np.array_equal(_bits(other(staged, k)), _bits(other(a, k)))


def test_pspotrf_sub_block_staged_equals_direct(monkeypatch):
    """The (4096, 4096) block at ia = ja = 513 of a 5120 matrix; every
    entry outside the block as the input had it."""
    dev = _card()
    n, nb, m = 4096, 512, 5120
    g = torch.Generator(device=dev).manual_seed(5)
    full = torch.rand((m, m), generator=g, device=dev) - 0.5
    full[nb:nb + n, nb:nb + n] = gen.random_hermitian_positive_definite(g, n, torch.float32)
    a = full.cpu().numpy()
    ctx = sl.dlaf_create_grid(1, 1)
    try:
        desc = np.array([1, ctx, m, m, nb, nb, 0, 0, m], dtype=np.int64)
        staged, direct = _pspotrf_both_routes(monkeypatch, dev, "L", n, a, nb + 1, desc, ctx)
    finally:
        sl.dlaf_free_grid(ctx)
    assert np.array_equal(_bits(staged), _bits(direct))
    inside = np.zeros((m, m), bool)
    inside[nb:nb + n, nb:nb + n] = True
    assert np.array_equal(_bits(staged[~inside]), _bits(a[~inside]))
