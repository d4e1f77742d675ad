"""The span recorder (``dlaf_tpu_torch.spans``) and the spans of the
distributed Cholesky's panel loop and of the ScaLAPACK surface, on the CPU.

Off, the recorder records nothing; on, ``cholesky`` at n = 2048, nb = 256
(panels of 3 tiles: two whole, one of 2) gives one span a call, a panel, a
tile step and a trailing update, each inside its parent with its call id,
and the same factor bit for bit; ``dlaf_pspotrf`` gives the surface's
steps in order around the nested ``cholesky``.
"""
import time
import types

import numpy as np
import pytest
import torch

from dlaf_tpu_torch import spans
from dlaf_tpu_torch.algos.cholesky import cholesky
from dlaf_tpu_torch.api import scalapack as sl
from dlaf_tpu_torch.comm.mesh import Grid
from dlaf_tpu_torch.matrix import generators as gen
from dlaf_tpu_torch.matrix.dist_matrix import DistMatrix
from dlaf_tpu_torch.ops.kernels.potrf import potrf_tile
from dlaf_tpu_torch.ops.kernels.trailing import ksub_matmul_masked
from dlaf_tpu_torch.tune import get_tune_parameters, set_tune_parameters

N, NB, PANEL_TILES = 2048, 256, 3
STEPS = ("cholesky.leaf", "cholesky.solve", "cholesky.panel_bcast", "cholesky.panel_update")


@pytest.fixture
def recorder():
    """The recorder off and empty before and after the test."""
    spans.disable()
    spans.drain()
    yield spans
    spans.disable()
    spans.drain()


def _spd(n, seed=0):
    return gen.random_hermitian_positive_definite(torch.Generator().manual_seed(seed), n,
                                                  torch.float32)


@pytest.fixture(scope="module")
def factors():
    """{uplo: (factor off, factor on, records, dropped)} of one call each."""
    old = get_tune_parameters().potrf_dist_panel_width
    set_tune_parameters(potrf_dist_panel_width=PANEL_TILES * NB)
    spans.disable()
    spans.drain()
    out = {}
    try:
        dm = DistMatrix.from_global(_spd(N), NB, Grid((1, 1)))
        for uplo in ("L", "U"):
            off = cholesky(dm, uplo=uplo).data
            assert spans.drain() == ([], 0)
            spans.enable()
            on = cholesky(dm, uplo=uplo).data
            spans.disable()
            out[uplo] = (off, on, *spans.drain())
    finally:
        set_tune_parameters(potrf_dist_panel_width=old)
        spans.disable()
        spans.drain()
    return out


def test_off_records_nothing(recorder):
    assert not recorder.enabled()
    with recorder.span("x", n=1) as s:
        with recorder.span("y"):
            pass
    assert s is not None and recorder.drain() == ([], 0)
    cholesky(DistMatrix.from_global(_spd(256), 64, Grid((1, 1))))
    assert recorder.drain() == ([], 0)


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_factor_bit_equal_on_and_off(factors, uplo):
    off, on, _, _ = factors[uplo]
    assert torch.equal(off, on)


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_cholesky_spans(factors, uplo):
    _, _, recs, dropped = factors[uplo]
    assert dropped == 0
    nrt = N // NB
    npanels = -(-nrt // PANEL_TILES)
    top = recs[0]
    assert (top.name, top.parent) == ("cholesky", -1)
    assert top.attrs == {"n": N, "nb": NB, "uplo": uplo, "wt_tiles": PANEL_TILES,
                         "grid": (1, 1)}
    by_index = {r.index: r for r in recs}
    assert len(by_index) == len(recs) and all(r.call == top.call for r in recs)
    for r in recs[1:]:
        parent = by_index[r.parent]
        assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns
        want = {"cholesky.panel": "cholesky", "cholesky.trailing": "cholesky"}.get(
            r.name, "cholesky.panel")
        assert parent.name == want, r.name
    panels = [r for r in recs if r.name == "cholesky.panel"]
    trailing = [r for r in recs if r.name == "cholesky.trailing"]
    assert [p.attrs["pk"] for p in panels] == list(range(npanels))
    assert [t.attrs["pk"] for t in trailing] == list(range(npanels - 1))
    for p in panels:
        steps = [r.name for r in recs if r.parent == p.index]
        tiles = min(PANEL_TILES, nrt - p.attrs["pk"] * PANEL_TILES)
        assert steps == list(STEPS) * tiles
    # siblings in time order, never overlapping
    kids = [r for r in recs if r.parent == top.index]
    assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
    assert [r.name for r in kids] == ["cholesky.panel", "cholesky.trailing"] * (npanels - 1) + \
        ["cholesky.panel"]
    assert len(recs) == 1 + npanels + (npanels - 1) + 4 * nrt
    # the plain kernels on the CPU launch nothing; only the call's span counts
    assert top.counts == {"k1": 0, "k6": 0, "k6_pipelined": 0}
    assert all(r.counts is None for r in recs[1:])


def test_pspotrf_surface_spans(recorder):
    n, nb = 512, 64
    a = _spd(n, 1).numpy()
    ctx = sl.dlaf_create_grid(1, 1)
    try:
        desc = np.array([1, ctx, n, n, nb, nb, 0, 0, n], dtype=np.int64)
        want = sl.dlaf_pspotrf("L", n, a, 1, 1, desc, ctx, device="cpu")
        recorder.enable()
        got = sl.dlaf_pspotrf("L", n, a, 1, 1, desc, ctx, device="cpu")
        recorder.disable()
    finally:
        sl.dlaf_free_grid(ctx)
    assert np.array_equal(got, want)
    recs, dropped = recorder.drain()
    assert dropped == 0
    top = recs[0]
    assert (top.name, top.parent, top.attrs) == (
        "surface.pspotrf", -1, {"entry": "dlaf_cholesky_factorization", "n": n})
    kids = [r for r in recs if r.parent == top.index]
    assert [r.name for r in kids] == ["surface.to_card", "surface.distribute", "cholesky",
                                      "surface.gather", "surface.keep_triangle",
                                      "surface.to_host"]
    assert kids[0].attrs == kids[-1].attrs == {"bytes": n * n * 4, "route": "direct",
                                               "chunks": 1}
    assert all(r.call == top.call for r in recs)
    assert all(top.start_ns <= r.start_ns <= r.end_ns <= top.end_ns for r in recs)
    assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
    inner = kids[2]
    assert {r.name for r in recs if r.parent == inner.index} == {"cholesky.panel"}


def test_full_buffer_counts_drops(recorder, monkeypatch):
    monkeypatch.setattr(recorder, "CAPACITY", 3)
    recorder.enable()
    for i in range(5):
        with recorder.span("s", i=i):
            pass
    recs, dropped = recorder.drain()
    assert [r.attrs["i"] for r in recs] == [0, 1, 2] and dropped == 2
    with recorder.span("after"):
        pass
    after, dropped = recorder.drain()
    assert [r.name for r in after] == ["after"] and dropped == 0
    assert after[0].index == recs[-1].index + 1       # indices go on across drains


def test_call_ids_and_counters(recorder, monkeypatch):
    """Each top-level span opens a call; K1's and K6's launches inside the
    call, and K6's on its pipelined route, are its top-level span's counts,
    and the spans inside it count nothing."""
    monkeypatch.setattr(potrf_tile, "launches", potrf_tile.launches)
    monkeypatch.setattr(ksub_matmul_masked, "launches", ksub_matmul_masked.launches)
    monkeypatch.setattr(ksub_matmul_masked, "pipelined", ksub_matmul_masked.pipelined)
    recorder.enable()
    for _ in range(2):
        with recorder.span("top"):
            potrf_tile.launches += 1
            with recorder.span("inner"):
                ksub_matmul_masked.launches += 3
                ksub_matmul_masked.pipelined += 2
                potrf_tile.launches += 2
    recs, _ = recorder.drain()
    assert [(r.name, r.parent) for r in recs] == [("top", -1), ("inner", recs[0].index),
                                                  ("top", -1), ("inner", recs[2].index)]
    assert recs[0].call == recs[1].call != recs[2].call == recs[3].call
    assert [r.counts for r in recs[:2]] == [{"k1": 3, "k6": 3, "k6_pipelined": 2}, None]


@pytest.mark.parametrize("was_on", [False, True])
def test_collect(recorder, was_on):
    """``collect`` records in its block; the records leave the buffer with
    the block only where the recorder was off."""
    if was_on:
        recorder.enable()
    with recorder.collect() as recs:
        with recorder.span("a"):
            pass
    assert [r.name for r in recs] == ["a"] and recs[0].end_ns >= recs[0].start_ns
    assert recorder.enabled() is was_on
    assert [r.name for r in recorder.drain()[0]] == (["a"] if was_on else [])


def test_collect_records_past_a_full_buffer(recorder, monkeypatch):
    """A ``collect`` block records every span even where the buffer is full,
    and the drops outside it are still counted."""
    monkeypatch.setattr(recorder, "CAPACITY", 1)
    recorder.enable()
    with recorder.span("first"):
        pass
    with recorder.collect() as recs:
        for name in ("a", "b"):
            with recorder.span(name):
                pass
    with recorder.span("dropped"):
        pass
    assert [r.name for r in recs] == ["a", "b"]
    got, dropped = recorder.drain()
    assert [r.name for r in got] == ["first", "a", "b"] and dropped == 1


def test_wall_clock_step_inside_a_call(recorder, monkeypatch):
    """The wall clock is read as a call opens; a step of it inside the call
    leaves the call's durations and nesting as the monotonic clock has them."""
    wall = [10**18]
    clock = types.SimpleNamespace(time_ns=lambda: wall[0], perf_counter_ns=time.perf_counter_ns)
    monkeypatch.setattr(recorder, "time", clock)
    recorder.enable()
    with recorder.span("top"):
        wall[0] -= 10**9                            # stepped back one second
        with recorder.span("inner"):
            time.sleep(0.001)
    wall[0] += 5 * 10**9
    with recorder.span("next"):
        pass
    top, inner, nxt = recorder.drain()[0]
    assert top.start_ns <= inner.start_ns < inner.end_ns <= top.end_ns
    assert 10**6 <= inner.end_ns - inner.start_ns < 10**9
    # five seconds forward from one second back, less the top span's time
    assert abs(nxt.start_ns - top.end_ns - 4 * 10**9) < 10**8
