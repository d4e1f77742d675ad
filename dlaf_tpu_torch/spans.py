"""Host spans and launch counters of the program, on the host's wall clock.

The port's one span system. The Cholesky panel loop
(``algos/cholesky.py``), the ScaLAPACK surface (``api/scalapack.py``) and
``eigh_large``'s stages open named spans::

    with spans.span("cholesky.panel", pk=pk):
        ...

Off (the default), ``span`` tests one module-level flag and returns a
shared no-op context: no clock reading, no record, no synchronization.
On (:func:`enable`), each span records

    (index, call, parent, name, start_ns, end_ns, attrs, counts)

- ``start_ns``/``end_ns``: ns on ``time.time_ns()``, the clock on which
  ``torch.profiler`` (kineto) stamps the device's kernels and copies and
  the host's CUDA runtime calls, so that a device interval or an idle gap
  can be put down to the span that held the host at that moment. The wall
  clock is read once as each top-level span opens; inside it, times
  advance on the monotonic ``time.perf_counter_ns()``, so a step of the
  wall clock never bends a call's durations or its nesting. A span never
  synchronizes the device: it measures the host.
- ``index``: the record's place among every record made since the process
  started (drains included); ``parent`` is the enclosing span's index, or
  -1 for a top-level span. Each top-level span opens a new ``call`` id,
  which its descendants carry.
- ``counts``: on a top-level span, the launches of K1
  (``potrf_tile.launches``) and K6 (``ksub_matmul_masked.launches``) made
  in the call, as ``k1`` and ``k6``, and those of K6's that took its
  pipelined route (``ksub_matmul_masked.pipelined``) as ``k6_pipelined``;
  ``None`` on the spans inside it.

Records stay in memory until :func:`drain` returns them. The buffer holds
at most ``CAPACITY`` records; a span opened while it is full is not
recorded and counted as dropped (inside :func:`collect`, whose caller
reads the block's records, every span is recorded). One thread: the
recorder keeps one stack of open spans, as the program's calls run on the
caller's thread.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

CAPACITY = 1 << 20

_on = False
_records: list = []
_stack: list = []
_base = 0          # records drained so far (the index of _records[0])
_calls = 0
_dropped = 0
_offset = 0        # time_ns() - perf_counter_ns(), read as the open call began
_collecting = 0    # open ``collect`` blocks, which record whatever the capacity
_k1 = _k6 = None   # the K1 and K6 wrappers, whose ``.launches`` are the counters


@dataclasses.dataclass(slots=True)
class Record:
    index: int
    call: int
    parent: int
    name: str
    start_ns: int
    end_ns: int
    attrs: dict
    counts: dict

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("rec", "k1", "k6", "k6p")

    def __init__(self, name, attrs):
        self.rec = Record(0, 0, -1, name, 0, 0, attrs, None)

    def __enter__(self):
        global _calls, _offset
        rec = self.rec
        rec.index = _base + len(_records)
        if _stack:
            rec.call, rec.parent = _stack[-1].call, _stack[-1].index
        else:
            _calls += 1
            rec.call = _calls
            self.k1, self.k6, self.k6p = _k1.launches, _k6.launches, _k6.pipelined
            _offset = time.time_ns() - time.perf_counter_ns()
        _records.append(rec)
        _stack.append(rec)
        rec.start_ns = time.perf_counter_ns() + _offset
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        rec.end_ns = time.perf_counter_ns() + _offset
        _stack.pop()
        if rec.parent == -1:
            rec.counts = {"k1": _k1.launches - self.k1, "k6": _k6.launches - self.k6,
                          "k6_pipelined": _k6.pipelined - self.k6p}
        return False


def span(name: str, **attrs):
    """A context manager that records the span ``name`` with ``attrs``
    while the recorder is on, and does nothing while it is off."""
    global _dropped
    if not _on:
        return _NULL
    if len(_records) >= CAPACITY and not _collecting:
        _dropped += 1
        return _NULL
    return _Span(name, attrs)


def enable() -> None:
    """Turn the recorder on (the kernel wrappers' counters are resolved here,
    not when this module is imported)."""
    global _on, _k1, _k6
    from .ops.kernels.potrf import potrf_tile as _k1
    from .ops.kernels.trailing import ksub_matmul_masked as _k6
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def drain() -> tuple:
    """``(records, dropped)``: the records made since the last drain (spans
    still open among them end when they close) and the number of spans
    dropped for a full buffer; both are cleared."""
    global _records, _base, _dropped
    out, dropped = _records, _dropped
    _base += len(out)
    _records, _dropped = [], 0
    return out, dropped


@contextlib.contextmanager
def collect():
    """Record inside the block whether or not the recorder is on, and
    whether or not its buffer is full, and yield a list that receives the
    records made in it when the block ends. Where the recorder was off,
    they leave the buffer with the block."""
    global _collecting
    was, start, out = _on, len(_records), []
    if not was:
        enable()
    _collecting += 1
    try:
        yield out
    finally:
        _collecting -= 1
        out.extend(_records[start:])
        if not was:
            del _records[start:]
            disable()
