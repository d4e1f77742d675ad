"""Kernel launches a traced call that the host issued inside the Cholesky
panel's tile steps (the launch runtime calls of the device trace whose
start lies in ``cholesky.leaf``, ``cholesky.solve``,
``cholesky.panel_bcast`` or ``cholesky.panel_update``,
``program_spans.launches``). Extras: ``launches.<span>`` a call for every
innermost span and ``outside``, and the program's own counters ``k1`` and
``k6`` (the K1 and K6 wrappers' launches) a call."""
from portbench import program_spans
from portbench.metrics.panel_idle_share import STEPS

NAME = "panel_launches_per_call"
UNIT = "launches"
BETTER = "lower"
LAYER = "distributed Cholesky (host dispatch)"
SOURCE = "program_span"
MOVES = "call_s"


def read(r):
    recs = program_spans.records(r.trace)
    if not recs or not r.trace.calls:
        return None
    by_span = program_spans.launches(r.trace, recs)
    if sum(by_span.values()) == 0:
        return None
    calls = r.trace.calls
    out = {"value": sum(by_span.get(s, 0) for s in STEPS) / calls}
    out.update({f"launches.{name}": n / calls for name, n in sorted(by_span.items())})
    out.update({name: n / calls for name, n in sorted(program_spans.counts(recs).items())})
    return out
