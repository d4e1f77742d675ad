"""K3's share of its roofline: the least time of the bulge chase from band b
to tridiagonal (``roofline.band_chase`` from n, b and the dtype, against
495 TFLOP/s and 3.35 TB/s) over the device time of K3's kernel a call
(``chase_kernel``), in %."""
from portbench import roofline

NAME = "k3_roofline"
UNIT = "%"
BETTER = "higher"
LAYER = "stage-2 chase"
SOURCE = "device_trace"
MOVES = "call_s"


def read(r):
    if r.trace is None or not r.trace.calls:
        return None
    ks = r.trace.kernels(lambda n: "chase_kernel<" in n)
    if not ks:
        return None
    k3_s = sum(e - s for _, s, e in ks) / 1e9 / r.trace.calls
    cplx = r.params["dtype"].startswith("complex")
    work = roofline.band_chase(int(r.params["n"]), int(r.params["band"]),
                               elem_bytes=8 if cplx else 4, is_complex=cplx)
    return {"value": 100.0 * work.least_s() / k3_s, "bound": work.bound(),
            "kernel_s": k3_s, "launches": len(ks) / r.trace.calls}
