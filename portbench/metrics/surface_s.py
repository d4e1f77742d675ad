"""The ScaLAPACK surface's own seconds a ``dlaf_pspotrf`` call: the call's
time outside a span around the driver it calls (``algos.cholesky.cholesky``,
synchronized at both ends): the host copies each way, the descriptor and
the numpy work, the shard and the other triangle's restore."""
NAME = "surface_s"
UNIT = "s"
BETTER = "lower"
LAYER = "user surfaces"
SOURCE = "program_span"
MOVES = "call_s"
SPANS = {"cholesky_driver": ("dlaf_tpu_torch.algos.cholesky", "cholesky")}


def read(r):
    s = r.spans.get("cholesky_driver")
    if not s or not r.span_call_s:
        return None
    return (sum(r.span_call_s) - sum(s)) / len(r.span_call_s)
