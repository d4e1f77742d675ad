"""Stage 3 of the distributed eigensolver: seconds a call in
``dist_driver.tridiag_eigh_dist`` (the tridiagonal divide and conquer), a
span synchronized at both ends."""
NAME = "tridiag_dc_s"
UNIT = "s"
BETTER = "lower"
LAYER = "distributed eigensolver"
SOURCE = "program_span"
MOVES = "call_s"
SPANS = {"tridiag_dc": ("dlaf_tpu_torch.algos.eigensolver.dist_driver", "tridiag_eigh_dist")}


def read(r):
    s = r.spans.get("tridiag_dc")
    return sum(s) / len(r.span_call_s) if s and r.span_call_s else None
