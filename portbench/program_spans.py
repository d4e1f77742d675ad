"""The program's own spans (``dlaf_tpu_torch.spans``) read against a traced window.

Importing this module turns the program's span recorder on. Only a
``--trace 1`` run loads the metric readers that import it (the harness
loads none with ``--trace 0``), so the untraced runs keep the recorder off.
A program without the recorder leaves every reader with nothing to read.

The recorder stamps its spans with ``time.time_ns()``, the clock of the
traced window and of kineto's events (``tracing.py``), so an idle gap, a
launch or a copy on the trace can be put down to the span that held the
host at that moment:

- :func:`records`: the records of the calls whose top-level span lies in
  the traced window;
- :func:`idle_ns`: the window's idle gaps split over the innermost spans
  by overlap, ``outside`` where no span held the host (the harness's
  synchronize and its loop between calls);
- :func:`launches`: the kernel launches (the host's ``cudaLaunch*`` and
  ``cuLaunch*`` runtime calls) by the innermost span that holds each
  call's start;
- :func:`copy_ns`: the device time of the copies of one direction inside
  the spans of one name.
"""
from __future__ import annotations

import bisect

from portbench import tracing

try:
    from dlaf_tpu_torch import spans as _recorder
except ImportError:          # a program without the recorder
    _recorder = None
else:
    _recorder.enable()

OUTSIDE = "outside"
LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch")

_kept: list = []


def records(trace) -> list:
    """The program's records of the calls whose top-level span starts and
    ends inside the traced window (every reader of one run gets the same)."""
    if _recorder is None or trace is None:
        return []
    _kept.extend(_recorder.drain()[0])
    # a later window starts later: what ended before this one is never read
    _kept[:] = [r for r in _kept if r.end_ns >= trace.start]
    calls = {r.call for r in _kept
             if r.parent == -1 and trace.start <= r.start_ns and r.end_ns <= trace.end}
    return [r for r in _kept if r.call in calls]


def self_intervals(recs) -> list:
    """Sorted disjoint ``(start, end, name)``: each span's time outside its
    children, i.e. the innermost span at each moment."""
    kids: dict = {}
    for r in recs:
        kids.setdefault(r.parent, []).append(r)
    out = []
    for r in recs:
        t = r.start_ns
        for c in sorted(kids.get(r.index, ()), key=lambda c: c.start_ns):
            if c.start_ns > t:
                out.append((t, c.start_ns, r.name))
            t = max(t, c.end_ns)
        if r.end_ns > t:
            out.append((t, r.end_ns, r.name))
    return sorted(out)


def idle_ns(trace, recs) -> dict:
    """ns of the window's idle time by the innermost span that held the
    host, and ``outside``; the values sum to the window's idle time."""
    selfs = self_intervals(recs)
    out = {OUTSIDE: 0}
    i = 0
    for g0, g1 in sorted(tracing.gaps(trace)):
        while i < len(selfs) and selfs[i][1] <= g0:
            i += 1
        covered = 0
        j = i
        while j < len(selfs) and selfs[j][0] < g1:
            s, e, name = selfs[j]
            ov = min(e, g1) - max(s, g0)
            if ov > 0:
                out[name] = out.get(name, 0) + ov
                covered += ov
            j += 1
        out[OUTSIDE] += g1 - g0 - covered
    return out


def launches(trace, recs) -> dict:
    """Kernel launches by the innermost span that holds the launch call's
    start, and ``outside``. A launch call inside another (a driver call
    made by a runtime call) is the same launch and counts once."""
    calls = sorted(((s, -e) for n, s, e in trace.host if n.startswith(LAUNCH_PREFIXES)))
    selfs = self_intervals(recs)
    starts = [s for s, _, _ in selfs]
    out = {OUTSIDE: 0}
    last_end = None
    for s, neg_e in calls:
        if last_end is not None and -neg_e <= last_end:
            continue
        last_end = -neg_e
        k = bisect.bisect_right(starts, s) - 1
        name = selfs[k][2] if k >= 0 and s < selfs[k][1] else OUTSIDE
        out[name] = out.get(name, 0) + 1
    return out


def copy_ns(trace, recs, name: str, direction: str) -> int:
    """ns of the device's ``direction`` copies (``HtoD``, ``DtoH``) inside
    the spans named ``name``."""
    spans = [(r.start_ns, r.end_ns) for r in recs if r.name == name]
    copies = [(s, e) for k, n, s, e in trace.device if k == "gpu_memcpy" and direction in n]
    return sum(max(0, min(e, se) - max(s, ss)) for ss, se in spans for s, e in copies)


def counts(recs) -> dict:
    """The program's counters (``k1``, ``k6``) summed over the calls."""
    out: dict = {}
    for r in recs:
        if r.parent == -1:
            for k, v in r.counts.items():
                out[k] = out.get(k, 0) + v
    return out
