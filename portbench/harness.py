"""One run of one cell: set-up, the measured window, the trace, the output check.

The window is a closed loop: each call of the program is followed by a
synchronize of the card before the next starts. It closes at the end of the
first call that ends at or after ``seconds``, so a long call is never cut.

- ``--trace 0``: the cell's end-to-end metrics, from the host's clock:
  ``call_s`` (the window's wall time over the calls in it; ``call_s.<group>``
  in a group of cells whose spread sets another bound),
  ``call_p95_s`` (the 95th percentile of every call's time),
  ``peak_mem_gib`` (the program's peak allocation on the card during a call
  of the window, less what the harness holds of the sampled output) and
  ``setup_s`` (everything before the window, from the start of the process).
- ``--trace 1``: the cell's per-layer metrics. The window starts with
  ``span_calls`` calls under the spans that the metrics name (each wrapped
  program function synchronized at both ends), then ``trace_calls`` calls
  under ``torch.profiler`` (the device's activity), then plain calls until
  ``seconds``.

After the window, the output of one call, drawn from the seed among the
first ``sample_calls``, is judged by the plain reference against the input
made again from the seed, once the program's state is freed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import json
import statistics
import subprocess
import sys
import time
import traceback
import warnings
from typing import Optional

import torch

from portbench import spec, tracing, traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "dlaf_tpu")


class Refused(RuntimeError):
    """The run cannot give a result (no card, or a forbidden module loaded)."""


@dataclasses.dataclass
class Reading:
    """What a per-layer metric's ``read`` gets."""
    params: dict
    trace: Optional[tracing.Trace]
    spans: dict            # span name -> [seconds], one entry a wrapped call
    span_call_s: list      # the seconds of each call made under the spans


def forbidden_modules(names=None) -> list:
    """The top-level names among ``names`` (default: the loaded modules)
    that are one of FORBIDDEN, compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


class Spans:
    """Host-clock spans around program functions, named by the metrics."""

    def __init__(self, metrics, dev):
        self.targets = {}
        for m in metrics:
            self.targets.update(getattr(m, "SPANS", {}))
        self.seconds = {name: [] for name in self.targets}
        self.dev = dev

    def _wrap(self, name, fn):
        def span(*args, **kwargs):
            _sync(self.dev)
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                _sync(self.dev)
                self.seconds[name].append(time.perf_counter() - t)
        return span

    @contextlib.contextmanager
    def installed(self):
        saved = []
        try:
            for name, (modname, attr) in self.targets.items():
                mod = importlib.import_module(modname)
                orig = getattr(mod, attr)
                setattr(mod, attr, self._wrap(name, orig))
                saved.append((mod, attr, orig))
            yield
        finally:
            for mod, attr, orig in reversed(saved):
                setattr(mod, attr, orig)


def _cuda_bytes(answer: dict) -> int:
    """Bytes of the card's memory that the tensors of ``answer`` keep."""
    seen = {}
    for t in answer.values():
        if isinstance(t, torch.Tensor) and t.is_cuda:
            st = t.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def _profile(dev):
    """The device's activity on the card (the host's operators only on the
    CPU, where there is no device activity to record)."""
    from torch.profiler import ProfilerActivity, profile
    warnings.filterwarnings("ignore", message=".*Profiler clears events")
    acts = [ProfilerActivity.CUDA] if dev.type == "cuda" else [ProfilerActivity.CPU]
    return profile(activities=acts)


def run(cell: str, seed: int, seconds: float, trace: bool, t_start: float,
        device: Optional[str] = None, overrides: Optional[dict] = None,
        log=sys.stderr) -> dict:
    """One run of ``cell``; returns the result line as a dict. ``device``
    and ``overrides`` (traffic parameters) serve the tests on the CPU; the
    command line gives neither."""
    wl = spec.load_workload(cell)
    cfg = spec.load_config(wl["config"])
    p = spec.params(wl, cfg)
    p.update(overrides or {})
    entry = spec.load_entry(wl["entry"])
    ref = spec.load_reference(entry.CHECK)
    metrics = [spec.load_metric(m) for m in wl["per_layer"]] if trace else []
    dev = torch.device(device or "cuda:0")
    if dev.type == "cuda" and (not torch.cuda.is_available()
                               or torch.cuda.device_count() < int(wl["chips"])):
        raise Refused(f"cell {cell} needs {wl['chips']} CUDA device(s); "
                      f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)

    from dlaf_tpu_torch.ops.kernels import _build
    from dlaf_tpu_torch.tune import reset_tune_parameters, set_tune_parameters
    reset_tune_parameters()
    set_tune_parameters(**cfg.get("tune", {}))

    # set-up: the input, the program's objects, one warm-up of every shape
    parts = {"import_s": time.perf_counter() - t_start}
    a = traffic.make_matrix(p, seed, dev)
    _sync(dev)
    parts["input_s"] = time.perf_counter() - t_start - sum(parts.values())
    state = entry.prepare(p, a)
    del a
    _sync(dev)
    parts["prepare_s"] = time.perf_counter() - t_start - sum(parts.values())
    for _ in range(int(p.get("warmup_calls", 1))):
        out = entry.call(state)
        _sync(dev)
        del out
    setup_s = time.perf_counter() - t_start
    parts["warmup_s"] = setup_s - sum(parts.values())
    cuda = dev.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    # the window
    pick = traffic.sample_index(seed, int(p["sample_calls"]))
    durs, held, failed = [], None, 0
    # peaks of the calls in the window: the card's, and the program's (the
    # card's less the bytes of the sampled output the harness holds)
    peaks = {"card": 0, "program": 0, "held": 0, "open": True}

    def one_call() -> float:
        nonlocal held, failed
        k = len(durs)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        c0 = time.perf_counter()
        out = None
        try:
            out = entry.call(state)
            _sync(dev)
        except Exception:                        # counted; the run goes on
            failed += 1
            if failed == 1:
                traceback.print_exc(file=log)
        c1 = time.perf_counter()
        durs.append(c1 - c0)
        if cuda and peaks["open"]:
            top = torch.cuda.max_memory_allocated(dev)
            peaks["card"] = max(peaks["card"], top)
            peaks["program"] = max(peaks["program"], top - peaks["held"])
        if k == pick and out is not None:
            held = entry.answer(out, p)
            peaks["held"] = _cuda_bytes(held)
        return c1

    spans = Spans(metrics, dev)
    tr = None
    t0 = time.perf_counter()
    end = t0
    if trace:
        n_span = int(p.get("span_calls", 1)) if spans.targets else 0
        with spans.installed():
            for _ in range(n_span):
                end = one_call()
        span_call_s = durs[:n_span]
        n_trace = int(p.get("trace_calls", 1))
        with _profile(dev) as prof:
            w0 = time.time_ns()
            for _ in range(n_trace):
                end = one_call()
            w1 = time.time_ns()
        tr = tracing.from_events(prof.profiler.kineto_results.events(), (w0, w1), n_trace)
        del prof
    while not durs or end - t0 < seconds:
        end = one_call()
    window_s = end - t0
    calls = len(durs)
    peaks["open"] = False
    # a window of fewer calls than the picked one: the calls after it run
    # to the picked call, outside every metric
    while len(durs) <= pick:
        one_call()
    found = forbidden_modules()
    if found:
        raise Refused(f"forbidden modules loaded by the run: {found}")

    metrics_out = {}
    if trace:
        reading = Reading(p, tr, spans.seconds, span_call_s)
        for m in metrics:
            v = m.read(reading)
            if v is None:
                continue
            extra = v if isinstance(v, dict) else {"value": v}
            metrics_out[m.NAME] = {"value": extra.pop("value"), "unit": m.UNIT, **extra}
    else:
        e2e = {"call_s": window_s / calls, "peak_mem_gib": peaks["program"] / 2**30,
               "setup_s": setup_s}
        if calls >= 2:
            e2e["call_p95_s"] = statistics.quantiles(durs[:calls], n=20)[18]
        for name in wl["end_to_end"]:
            base = spec.split(name)[0]
            if base in e2e:
                metrics_out[name] = {"value": e2e[base], "unit": spec.END_TO_END[base]}
        if "call_p95_s" in wl["end_to_end"] and calls < 200:
            print(f"call_p95_s over {calls} calls, fewer than 200", file=log)

    # the output check, once the program's state is freed
    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = {}
    c0 = time.perf_counter()
    if held is not None:
        a = traffic.make_matrix(p, seed, dev)
        numbers = ref.judge(a, **held)
        del a, held
        recorded = getattr(ref, "RECORDED", ())
        for name, value in numbers.items():
            if name in recorded:
                print(f"recorded {name} {value!r} (not compared)", file=log)
            else:
                checks[name] = {"value": value, "limit": wl["limits"][name]}
    check_s = time.perf_counter() - c0
    correct = bool(checks) and failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())

    device_out = {"platform": "gpu" if cuda else dev.type,
                  "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                  "count": int(wl["chips"]) if cuda else 1,
                  "memory_peak_bytes": int(max(setup_peak, peaks["card"])),
                  "power_limit_w": power_limit_w() if cuda else None}
    result = {"correct": correct, "attempted": calls, "failed": failed,
              "metrics": metrics_out, "device": device_out}
    if trace:
        device_out["busy_s"] = tracing.busy_ns(tr) / 1e9
        device_out["window_s"] = tr.wall_s
        result["breakdown"] = {"device_ops": tracing.device_ops(tr),
                               "idle_gaps": tracing.idle_gaps(tr)}
    result["checks"] = checks
    found = forbidden_modules()
    if found:
        raise Refused(f"forbidden modules loaded by the run: {found}")
    # for the record, on standard error only: the result line keeps to its keys
    window = sorted(durs[:calls])
    record = {"window_s": window_s, "calls": calls, "call_min_s": window[0],
              "call_median_s": statistics.median(window), "call_max_s": window[-1],
              "setup_parts": parts, "check_s": check_s,
              "build_s": {name: b["seconds"] for name, b in _build.build_log.items()}}
    print(f"run {json.dumps(record)}", file=log)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}", file=log)
    if not checks:
        print("check none: no output of the sampled call to judge", file=log)
    return result
