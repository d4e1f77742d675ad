"""K6's share of its roofline: the least time of the staircase updates that
the factorization needs (``roofline.cholesky_trailing`` from n, nb and the
dtype, against 495 TFLOP/s and 3.35 TB/s) over the device time of K6's
kernel a call (``ksub_tf32x3_kernel`` with its last template argument,
``kMasked``, true), in %."""
import re

from portbench import roofline

NAME = "k6_roofline"
UNIT = "%"
BETTER = "higher"
LAYER = "trailing update"
SOURCE = "device_trace"
MOVES = "call_s"
_K = re.compile(r"ksub_tf32x3_kernel<([^>]*)>")


def is_k6(name: str) -> bool:
    m = _K.search(name)
    return bool(m) and m.group(1).split(",")[-1].strip() == "true"


def read(r):
    if r.trace is None or not r.trace.calls:
        return None
    ks = r.trace.kernels(is_k6)
    if not ks:
        return None
    k6_s = sum(e - s for _, s, e in ks) / 1e9 / r.trace.calls
    cplx = r.params["dtype"].startswith("complex")
    work = roofline.cholesky_trailing(int(r.params["n"]), int(r.params["nb"]),
                                      elem_bytes=8 if cplx else 4, is_complex=cplx)
    return {"value": 100.0 * work.least_s() / k6_s, "bound": work.bound(),
            "kernel_s": k6_s, "launches": len(ks) / r.trace.calls}
