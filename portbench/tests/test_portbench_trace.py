"""The trace's arithmetic on synthetic events: overlaps count once."""
from portbench import tracing


class Ev:
    def __init__(self, kind, name, s, e, cuda=None):
        self._kind, self._name, self._s, self._e = kind, name, s, e
        if kind is None:
            self.device_type = lambda: "DeviceType.CUDA" if cuda else "DeviceType.CPU"
            self.is_user_annotation = lambda: False
        else:
            self.activity_type = lambda: kind

    def name(self):
        return self._name

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e


def _trace(device, host=()):
    return tracing.Trace(0, 100, 1, [("kernel", f"k{i}", s, e) for i, (s, e) in enumerate(device)],
                         list(host))


def test_union_counts_overlaps_once():
    assert tracing.union([(10, 30), (20, 40), (60, 70), (65, 66), (80, 80)]) == [(10, 40), (60, 70)]


def test_idle_share_of_overlapping_intervals():
    tr = _trace([(10, 30), (20, 40), (60, 70)])
    assert tracing.busy_ns(tr) == 40
    assert tracing.idle_share(tr) == 0.6


def test_idle_share_without_device_activity_is_none():
    assert tracing.idle_share(_trace([])) is None


def test_gaps_longest_first_and_labelled():
    tr = _trace([(10, 30), (20, 40), (60, 70)], host=[("cudaStreamSynchronize", 35, 65)])
    assert tracing.gaps(tr) == [(70, 100), (40, 60), (0, 10)]
    labels = dict((round(s * 1e9), n) for n, s in tracing.idle_gaps(tr))
    assert labels[30] == "host -> end of window"
    assert labels[20] == "cudaStreamSynchronize -> k2"
    assert labels[10] == "host -> k0"


def test_from_events_clips_to_window_and_sorts_kinds():
    evs = [Ev("kernel", "k", 5, 20), Ev("gpu_memcpy", "Memcpy HtoD", 30, 50),
           Ev("gpu_user_annotation", "span", 0, 100), Ev("cuda_runtime", "cudaLaunchKernel", 8, 9),
           Ev("kernel", "late", 120, 130)]
    tr = tracing.from_events(evs, (10, 100), 2)
    assert tr.calls == 2
    assert tr.device == [("kernel", "k", 10, 20), ("gpu_memcpy", "Memcpy HtoD", 30, 50)]
    assert tr.host == []           # the runtime call ended before the window


def test_from_events_without_activity_type():
    evs = [Ev(None, "ksub", 10, 20, cuda=True), Ev(None, "Memcpy DtoH", 20, 30, cuda=True),
           Ev(None, "Memset (Device)", 30, 31, cuda=True), Ev(None, "cuLaunchKernel", 9, 11)]
    tr = tracing.from_events(evs, (0, 40), 1)
    assert [k for k, *_ in tr.device] == ["kernel", "gpu_memcpy", "gpu_memset"]
    assert tr.host == [("cuLaunchKernel", 9, 11)]
