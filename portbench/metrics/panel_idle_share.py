"""The share of the traced wall time in which the card is idle while the
host is inside one of the Cholesky panel's tile steps (the program's spans
``cholesky.leaf``, ``cholesky.solve``, ``cholesky.panel_bcast`` and
``cholesky.panel_update``), in %. The idle gaps of the device trace are
split over the innermost program span by overlap
(``program_spans.idle_ns``); the extras ``idle_s.<span>`` give the idle
seconds a call of every span, ``cholesky.trailing``, ``cholesky`` itself
and ``outside`` (no span: the harness's synchronize and loop) among them,
and sum to ``device_idle_share`` x the traced wall time."""
from portbench import program_spans

NAME = "panel_idle_share"
UNIT = "%"
BETTER = "lower"
LAYER = "distributed Cholesky"
SOURCE = "program_span"
MOVES = "call_s"
STEPS = ("cholesky.leaf", "cholesky.solve", "cholesky.panel_bcast", "cholesky.panel_update")


def read(r):
    recs = program_spans.records(r.trace)
    if not recs or not r.trace.device or not r.trace.calls:
        return None
    idle = program_spans.idle_ns(r.trace, recs)
    out = {"value": 100.0 * sum(idle.get(s, 0) for s in STEPS) / (r.trace.end - r.trace.start)}
    out.update({f"idle_s.{name}": ns / 1e9 / r.trace.calls for name, ns in sorted(idle.items())})
    return out
