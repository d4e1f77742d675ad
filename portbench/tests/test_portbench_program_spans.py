"""The readers of the program's own spans (``program_spans.py`` and the
metrics that use it) on synthetic traces and records: idle gaps split over
the innermost spans, launches by span, copy bandwidth, ``None`` where there
is nothing to read; on the CPU through the harness; on the card, that the
spans and the device trace share one clock."""
import io
import time
import types

import pytest

from portbench import harness, program_spans, spec, tracing
from portbench.metrics import (copy_gbps, panel_idle_share, panel_launches_per_call,
                               surface_idle_share)

SEED = 2**31 + 202
# importing program_spans turns the recorder on (a traced run's readers do);
# the tests turn it on only where they read it
program_spans._recorder.disable()


@pytest.fixture
def recording():
    """The program's recorder on for one test, drained and off after it."""
    program_spans._recorder.enable()
    yield
    program_spans._recorder.disable()
    program_spans._recorder.drain()
    program_spans._kept.clear()


def _rec(index, parent, name, s, e, call=1, **attrs):
    return types.SimpleNamespace(index=index, call=call, parent=parent, name=name,
                                 start_ns=s, end_ns=e, attrs=attrs, counts={})


# one call, window [0, 100): cholesky [10, 90) holds a panel [10, 50) with a
# leaf [10, 20) and a solve [25, 45), and a trailing update [60, 85)
CALL = [_rec(0, -1, "cholesky", 10, 90), _rec(1, 0, "cholesky.panel", 10, 50),
        _rec(2, 1, "cholesky.leaf", 10, 20), _rec(3, 1, "cholesky.solve", 25, 45),
        _rec(4, 0, "cholesky.trailing", 60, 85)]
CALL[0].counts = {"k1": 4, "k6": 7}


def _trace(device, host=(), calls=1):
    return tracing.Trace(0, 100, calls, list(device), list(host))


def _kernels(*intervals):
    return [("kernel", f"k{i}", s, e) for i, (s, e) in enumerate(intervals)]


def _reading(trace):
    return types.SimpleNamespace(trace=trace, params={}, spans={}, span_call_s=[])


def test_self_intervals_are_the_innermost_span():
    assert program_spans.self_intervals(CALL) == [
        (10, 20, "cholesky.leaf"), (20, 25, "cholesky.panel"), (25, 45, "cholesky.solve"),
        (45, 50, "cholesky.panel"), (50, 60, "cholesky"), (60, 85, "cholesky.trailing"),
        (85, 90, "cholesky")]


def test_idle_gaps_split_by_overlap():
    # busy [5, 15), [30, 40), [62, 80); gaps [0, 5), [15, 30), [40, 62), [80, 100)
    tr = _trace(_kernels((5, 15), (30, 40), (62, 80)))
    idle = program_spans.idle_ns(tr, CALL)
    assert idle == {"outside": 5 + 10, "cholesky.leaf": 5, "cholesky.panel": 5 + 5,
                    "cholesky.solve": 5 + 5, "cholesky": 10 + 5, "cholesky.trailing": 2 + 5}
    assert sum(idle.values()) == round(tracing.idle_share(tr) * 100)


def test_idle_extras_sum_to_the_idle_share():
    tr = _trace(_kernels((5, 15), (30, 40), (62, 80)), calls=2)
    r = _reading(tr)
    for reader in (panel_idle_share, surface_idle_share):
        out = _read_with(reader, r, CALL)
        idle_s = sum(v for k, v in out.items() if k.startswith("idle_s."))
        assert idle_s * tr.calls == pytest.approx(tracing.idle_share(tr) * tr.wall_s)
    out = _read_with(panel_idle_share, r, CALL)
    assert out["value"] == pytest.approx(100 * (5 + 5 + 5) / 100)     # leaf + solve
    assert out["idle_s.outside"] == pytest.approx(15e-9 / 2)
    assert _read_with(surface_idle_share, r, CALL)["value"] == 0


def test_launches_by_the_span_holding_their_start():
    host = [("cudaLaunchKernel", 12, 13), ("cudaLaunchKernel", 26, 30),
            ("cuLaunchKernel", 27, 29),                    # inside the runtime call: once
            ("cudaLaunchKernelExC", 47, 48), ("cudaMemcpyAsync", 51, 52),
            ("cuLaunchKernelEx", 70, 71), ("cudaLaunchKernel", 95, 96),
            ("cudaStreamSynchronize", 91, 99)]
    tr = _trace(_kernels((0, 1)), host)
    assert program_spans.launches(tr, CALL) == {
        "cholesky.leaf": 1, "cholesky.solve": 1, "cholesky.panel": 1,
        "cholesky.trailing": 1, "outside": 1}
    out = _read_with(panel_launches_per_call, _reading(tr), CALL)
    assert out["value"] == 2                      # leaf + solve; panel's own is not a step
    assert out["launches.outside"] == 1 and out["k1"] == 4 and out["k6"] == 7


def test_copy_bandwidth_of_the_surface_spans():
    recs = [_rec(0, -1, "surface.pspotrf", 0, 100),
            _rec(1, 0, "surface.to_card", 0, 40, bytes=80),
            _rec(2, 0, "cholesky", 40, 60),
            _rec(3, 0, "surface.to_host", 60, 100, bytes=120)]
    dev = [("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 5, 25),
           ("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 30, 50),
           ("kernel", "k", 45, 55),
           ("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 58, 90)]    # 2 ns before
    tr = _trace(dev)
    assert program_spans.copy_ns(tr, recs, "surface.to_card", "HtoD") == 20
    assert program_spans.copy_ns(tr, recs, "surface.to_host", "DtoH") == 30
    out = _read_with(copy_gbps, _reading(tr), recs)
    assert out["value"] == pytest.approx(200 / 50)
    assert out["to_card_gbps"] == 4 and out["to_host_gbps"] == 4
    assert out["to_card_bytes"] == 80 and out["to_host_s"] == pytest.approx(30e-9)
    idle = _read_with(surface_idle_share, _reading(tr), recs)
    # gaps [0, 5), [25, 30), [90, 100): to_card 10, to_host 10 of the 100 ns
    assert idle["value"] == pytest.approx(20.0)
    assert idle["idle_s.surface.to_card"] == pytest.approx(10e-9)


def _read_with(reader, reading, recs):
    saved = program_spans.records
    program_spans.records = lambda trace: recs
    try:
        return reader.read(reading)
    finally:
        program_spans.records = saved


@pytest.mark.parametrize("reader", [panel_idle_share, panel_launches_per_call, copy_gbps,
                                    surface_idle_share])
def test_none_without_records(reader, monkeypatch):
    tr = _trace(_kernels((5, 15)), [("cudaLaunchKernel", 1, 2)])
    assert _read_with(reader, _reading(tr), []) is None
    monkeypatch.setattr(program_spans, "_recorder", None)    # a program without spans
    assert program_spans.records(tr) == []
    assert reader.read(_reading(tr)) is None
    assert reader.read(_reading(None)) is None


def test_records_keep_the_calls_inside_the_window(monkeypatch):
    made = [_rec(0, -1, "cholesky", 5, 50, call=1), _rec(1, 0, "cholesky.panel", 6, 40, call=1),
            _rec(2, -1, "cholesky", 120, 180, call=2), _rec(3, 2, "cholesky.panel", 121, 170,
                                                            call=2),
            _rec(4, -1, "cholesky", 190, 260, call=3)]
    fake = types.SimpleNamespace(drain=lambda: (list(made), 0))
    monkeypatch.setattr(program_spans, "_recorder", fake)
    monkeypatch.setattr(program_spans, "_kept", [])
    tr = tracing.Trace(100, 200, 1, [], [])
    assert [r.index for r in program_spans.records(tr)] == [2, 3]
    made.clear()                                  # a second reader of the same run
    assert [r.index for r in program_spans.records(tr)] == [2, 3]
    assert [r.index for r in program_spans._kept] == [2, 3, 4]


def _with_metrics(monkeypatch, extra):
    load = spec.load_workload

    def patched(name):
        wl = load(name)
        return {**wl, "per_layer": wl["per_layer"] + extra.get(name, [])}
    monkeypatch.setattr(spec, "load_workload", patched)


EXTRA = {"cholesky-f32.n40960": ["panel_idle_share", "panel_launches_per_call"],
         "cholesky-f32.pspotrf-n20480": ["copy_gbps.host", "surface_idle_share.host"]}


@pytest.mark.parametrize("cell,n", [("cholesky-f32.n40960", 512),
                                    ("cholesky-f32.pspotrf-n20480", 448)])
def test_traced_run_on_the_cpu_reads_nothing_and_raises_nothing(cell, n, monkeypatch,
                                                                recording):
    """On the CPU the trace has no device activity: the readers give None
    and the result line leaves them out."""
    _with_metrics(monkeypatch, EXTRA)
    r = harness.run(cell, SEED, 0.05, True, time.perf_counter(), device="cpu",
                    overrides={"n": n, "nb": 64}, log=io.StringIO())
    assert r["correct"] and not set(r["metrics"]) & set(EXTRA[cell])


@pytest.mark.card
def test_spans_and_trace_share_one_clock(card, monkeypatch, recording):
    """A traced ``cholesky`` at n = 8192 through the harness, with the
    program's spans read: every launch of the traced calls starts inside a
    ``cholesky`` span, the launches found in spans are the trace's kernels
    a call within 1%, K6's wrapper counted the trace's K6 kernels, and the
    idle time split over the spans is the trace's idle time."""
    cell = "cholesky-f32.n40960"
    _with_metrics(monkeypatch, EXTRA)
    r = harness.run(cell, SEED, 2.0, True, time.perf_counter(), overrides={"n": 8192})
    assert r["correct"]
    m = r["metrics"]
    calls = spec.load_workload(cell)["params"]["trace_calls"]
    lp = m["panel_launches_per_call"]
    assert lp["launches.outside"] == 0
    in_spans = sum(v for k, v in lp.items() if k.startswith("launches."))
    assert abs(in_spans - m["launches_per_call"]["value"]) <= 0.01 * in_spans
    assert lp["k6"] == m["k6_roofline"]["launches"]
    idle = m["panel_idle_share"]
    idle_s = sum(v for k, v in idle.items() if k.startswith("idle_s.")) * calls
    want = m["device_idle_share"]["value"] / 100 * r["device"]["window_s"]
    assert idle_s == pytest.approx(want, rel=0.01)
