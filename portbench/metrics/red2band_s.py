"""Stage 1 of the distributed eigensolver: seconds a call in
``dist_driver.reduction_to_band_dist``, a span synchronized at both ends."""
NAME = "red2band_s"
UNIT = "s"
BETTER = "lower"
LAYER = "distributed eigensolver"
SOURCE = "program_span"
MOVES = "call_s"
SPANS = {"red2band": ("dlaf_tpu_torch.algos.eigensolver.dist_driver", "reduction_to_band_dist")}


def read(r):
    s = r.spans.get("red2band")
    return sum(s) / len(r.span_call_s) if s and r.span_call_s else None
