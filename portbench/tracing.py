"""From a ``torch.profiler`` trace to intervals, the idle share and the breakdown.

The profiler records the device's kernels and copies, and the host's CUDA
runtime calls, on the host's clock (ns since the epoch, as
``time.time_ns()``). On the card it records no host operators: their
instrumentation tripled the time of a call of 2,500 launches, and would
make a host-bound call read idler than it is. The benchmark reads the raw
events (``prof.profiler.kineto_results.events()``), never the profiler's
per-op sums, so that kernels and copies that overlap are counted once: the
device is busy on the union of their intervals, and idle on the rest of the
traced window, the host's ``time.time_ns()`` from before the first traced
call to after the last one's synchronize.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple

# device activities that occupy the card (kineto's activity types)
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Trace:
    """What the per-layer readers get from a traced window (ns, one clock)."""
    start: int
    end: int
    calls: int
    device: List[Tuple[str, str, int, int]]        # (kind, name, start, end)
    host: List[Tuple[str, int, int]]               # (name, start, end)

    @property
    def wall_s(self) -> float:
        return (self.end - self.start) / 1e9

    def kernels(self, match=None) -> List[Tuple[str, int, int]]:
        return [(n, s, e) for k, n, s, e in self.device
                if k == "kernel" and (match is None or match(n))]


def _kind(ev) -> str:
    """The event's kineto activity type (``activity_type()`` where the
    installed PyTorch has it, else worked out from the device and name)."""
    kind = getattr(ev, "activity_type", None)
    if callable(kind):
        return kind()
    user = getattr(ev, "is_user_annotation", None)
    user = bool(user()) if callable(user) else False
    if str(ev.device_type()).endswith("CPU"):
        return "user_annotation" if user else "cpu_op"
    if user:
        return "gpu_user_annotation"
    name = ev.name()
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def _end(ev) -> int:
    end = getattr(ev, "end_ns", None)
    return end() if callable(end) else ev.start_ns() + ev.duration_ns()


def from_events(events: Iterable, window: Tuple[int, int], calls: int) -> Trace:
    """A :class:`Trace` of ``calls`` calls from kineto events (objects with
    ``name()``, ``start_ns()``, ``end_ns()`` or ``duration_ns()``, and
    ``activity_type()`` or ``device_type()``), clipped to ``window``
    ((start, end) in ns on the profiler's clock, ``time.time_ns()``)."""
    s0, s1 = window
    device, host = [], []
    for ev in events:
        kind = _kind(ev)
        start, end = ev.start_ns(), _end(ev)
        if end <= s0 or start >= s1:
            continue
        if kind in DEVICE_KINDS:
            device.append((kind, ev.name(), max(start, s0), min(end, s1)))
        elif kind in HOST_KINDS:
            host.append((ev.name(), start, end))
    return Trace(s0, s1, calls, device, host)


def union(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of [start, end) intervals as sorted disjoint intervals."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def busy_ns(trace: Trace) -> int:
    return sum(e - s for s, e in union([(s, e) for _, _, s, e in trace.device]))


def idle_share(trace: Trace) -> Optional[float]:
    """The share of the traced wall time in which nothing ran on the device
    (0..1), or None for a trace with no device activity."""
    if not trace.device or trace.end <= trace.start:
        return None
    return 1.0 - busy_ns(trace) / (trace.end - trace.start)


def gaps(trace: Trace) -> List[Tuple[int, int]]:
    """The idle intervals of the traced window, longest first."""
    busy = union([(s, e) for _, _, s, e in trace.device])
    out, t = [], trace.start
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if trace.end > t:
        out.append((t, trace.end))
    return sorted(out, key=lambda g: g[0] - g[1])


def host_label(trace: Trace, t0: int, t1: int) -> str:
    """What the host did in the gap [t0, t1): the innermost host event that
    holds t0 (a runtime call such as a synchronize or a copy; "host" where
    none does), and the device operation that ended the gap."""
    holding = sorted((s, n) for n, s, e in trace.host if s <= t0 < e)
    first = holding[-1][1] if holding else "host"
    after = [(s, n) for _, n, s, _ in trace.device if s >= t1]
    nxt = min(after)[1][:80] if after else "end of window"
    return f"{first} -> {nxt}"


def device_ops(trace: Trace, top: int = 10) -> List[list]:
    """[name, seconds] of the device operations that took the most time,
    by name (the sum of each name's own intervals)."""
    tot: dict = {}
    for _, n, s, e in trace.device:
        tot[n] = tot.get(n, 0) + (e - s)
    rows = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
    return [[n[:160], v / 1e9] for n, v in rows]


def idle_gaps(trace: Trace, top: int = 10) -> List[list]:
    """[host label, seconds] of the longest idle gaps."""
    return [[host_label(trace, s, e)[:160], (e - s) / 1e9] for s, e in gaps(trace)[:top]]
