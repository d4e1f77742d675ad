"""Whole runs of every cell on the CPU at small sizes: the result line, and
``correct`` false with the timed path broken underneath.

These runs skip the harness's look for a card (``device="cpu"``); the
program runs its kernels' plain versions."""
import io
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness, spec

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SMALL = {"cholesky-f32.n40960": {"n": 512, "nb": 64},
         "cholesky-f32.n10240": {"n": 384, "nb": 64},
         "cholesky-f32.pspotrf-n20480": {"n": 448, "nb": 64},
         "eigensolver-f32.n10240": {"n": 256, "nb": 64, "band": 64}}
SEED = 2**31 + 12345


def _run(cell, trace=False, seconds=0.05, log=None):
    return harness.run(cell, SEED, seconds, trace, time.perf_counter(), device="cpu",
                       overrides=SMALL[cell], log=log or io.StringIO())


def test_every_cell_has_a_small_size():
    assert sorted(SMALL) == spec.names("workloads")


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_result_line(cell):
    log = io.StringIO()
    r = _run(cell, log=log)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    wl = spec.load_workload(cell)
    assert set(r["metrics"]) == set(wl["end_to_end"]) - ({"call_p95_s"} if r["attempted"] < 2
                                                         else set())
    assert set(r["checks"]) == set(wl["limits"])
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(r)
    # standard error: the record of the run, then each compared number last
    lines = log.getvalue().splitlines()
    tail = lines[-len(r["checks"]):]
    assert [t.split()[1] for t in tail] == list(r["checks"])
    assert all(t.startswith("check ") and t.endswith(" ok") for t in tail)
    record = json.loads(lines[-len(r["checks"]) - 1][len("run "):])
    assert record["calls"] == r["attempted"] and record["window_s"] > 0


@pytest.mark.parametrize("cell", ["cholesky-f32.pspotrf-n20480", "eigensolver-f32.n10240"])
def test_traced_result_line(cell):
    r = _run(cell, trace=True)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                       "checks"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["correct"] is True
    assert {"busy_s", "window_s"} <= set(r["device"])
    # on the CPU only the spans have something to read
    wl = spec.load_workload(cell)
    spans = {m for m in wl["per_layer"] if spec.load_metric(m).SPANS}
    assert set(r["metrics"]) == spans
    for v in r["metrics"].values():
        assert v["value"] > 0


def _patched(monkeypatch, modname, attr, fault):
    import importlib
    mod = importlib.import_module(modname)
    real = getattr(mod, attr)
    monkeypatch.setattr(mod, attr, lambda *a, **k: fault(real, *a, **k))


def _unchanged(real, dm, *a, **k):
    from dlaf_tpu_torch.matrix.dist_matrix import DistMatrix
    return DistMatrix(dm.data.clone(), dm.dist, dm.grid)


def _one_entry_altered(real, *a, **k):
    out = real(*a, **k)
    out.data[300, 17] += 1e-3 * out.data[300, 300]
    return out


@pytest.mark.parametrize("cell", ["cholesky-f32.n40960", "cholesky-f32.n10240",
                                  "cholesky-f32.pspotrf-n20480"])
@pytest.mark.parametrize("fault", [_unchanged, _one_entry_altered])
def test_cholesky_fault_is_not_correct(monkeypatch, cell, fault):
    _patched(monkeypatch, "dlaf_tpu_torch.algos.cholesky", "cholesky", fault)
    r = _run(cell)
    assert r["correct"] is False
    assert r["checks"]["factor_err"]["value"] > r["checks"]["factor_err"]["limit"]


def _vector_lost(real, *a, **k):
    w, v = real(*a, **k)
    v.data[:, 100] = v.data[:, 101]
    return w, v


def _value_altered(real, *a, **k):
    w, v = real(*a, **k)
    w[200] += 0.01 * float(w.abs().max())
    return w, v


@pytest.mark.parametrize("fault", [_vector_lost, _value_altered])
def test_eigensolver_fault_is_not_correct(monkeypatch, fault):
    _patched(monkeypatch, "dlaf_tpu_torch.algos.eigensolver.dist_driver", "eigh_dist", fault)
    r = _run("eigensolver-f32.n10240")
    assert r["correct"] is False


def test_failed_call_is_counted(monkeypatch):
    from dlaf_tpu_torch.algos import cholesky as chol
    real = chol.cholesky
    calls = []

    def flaky(*a, **k):
        calls.append(1)
        if len(calls) == 8:          # a call of the window (5 warm-up calls first)
            raise RuntimeError("planted")
        return real(*a, **k)
    monkeypatch.setattr(chol, "cholesky", flaky)
    r = _run("cholesky-f32.n10240", seconds=0.3)
    assert r["failed"] == 1 and r["correct"] is False


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "cholesky-f32.n10240",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr
