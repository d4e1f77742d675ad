"""Kernel launches a call: the kernels in the trace over the traced calls
(the host's dispatch work, one launch at a time)."""
NAME = "launches_per_call"
UNIT = "launches"
BETTER = "lower"
LAYER = "device (host dispatch)"
SOURCE = "device_trace"
MOVES = "call_s"


def read(r):
    if r.trace is None or not r.trace.calls:
        return None
    n = len(r.trace.kernels())
    return n / r.trace.calls if n else None
