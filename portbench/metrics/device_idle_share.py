"""The share of the traced calls' wall time in which no kernel or copy ran
on the card: 1 - |union of the device intervals| / wall, both from the same
traced window (``tracing.idle_share``)."""
from portbench import tracing

NAME = "device_idle_share"
UNIT = "%"
BETTER = "lower"
LAYER = "device"
SOURCE = "device_trace"
MOVES = "call_s"


def read(r):
    if r.trace is None:
        return None
    share = tracing.idle_share(r.trace)
    return None if share is None else 100.0 * share
