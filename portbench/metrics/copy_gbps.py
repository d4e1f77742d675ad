"""The ScaLAPACK surface's host copies: the bytes of ``surface.to_card``
and ``surface.to_host`` (the program's spans, with the bytes they copy)
over the device seconds of the host-to-card and card-to-host copies inside
them (``program_spans.copy_ns``), in GB/s. Extras: bytes and seconds a
call and GB/s of each direction."""
from portbench import program_spans

NAME = "copy_gbps"
UNIT = "GB/s"
BETTER = "higher"
LAYER = "user surfaces"
SOURCE = "program_span"
MOVES = "call_s"
COPIES = (("to_card", "surface.to_card", "HtoD"), ("to_host", "surface.to_host", "DtoH"))


def read(r):
    recs = program_spans.records(r.trace)
    if not recs or not r.trace.calls:
        return None
    out, total_b, total_ns = {}, 0, 0
    for key, span, direction in COPIES:
        b = sum(rec.attrs.get("bytes", 0) for rec in recs if rec.name == span)
        ns = program_spans.copy_ns(r.trace, recs, span, direction)
        if not b or not ns:
            continue
        out[f"{key}_bytes"] = b / r.trace.calls
        out[f"{key}_s"] = ns / 1e9 / r.trace.calls
        out[f"{key}_gbps"] = b / ns
        total_b += b
        total_ns += ns
    if not total_ns:
        return None
    return {"value": total_b / total_ns, **out}
