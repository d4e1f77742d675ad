"""The share of the traced wall time in which the card is idle while the
host is in the ScaLAPACK surface's own steps (an innermost program span
named ``surface.*``: the entry's argument handling, the copies each way,
the shard, the gather, the other triangle's restore; ``cholesky``'s spans
not among them), in %. Extras: ``idle_s.<span>`` a call of every innermost
span and ``outside``, summing to ``device_idle_share`` x the traced wall
time (``program_spans.idle_ns``)."""
from portbench import program_spans

NAME = "surface_idle_share"
UNIT = "%"
BETTER = "lower"
LAYER = "user surfaces"
SOURCE = "program_span"
MOVES = "call_s"


def read(r):
    recs = program_spans.records(r.trace)
    if not recs or not r.trace.device or not r.trace.calls:
        return None
    idle = program_spans.idle_ns(r.trace, recs)
    surface = sum(ns for name, ns in idle.items() if name.startswith("surface."))
    out = {"value": 100.0 * surface / (r.trace.end - r.trace.start)}
    out.update({f"idle_s.{name}": ns / 1e9 / r.trace.calls for name, ns in sorted(idle.items())})
    return out
