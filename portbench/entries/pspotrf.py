"""Entry ``pspotrf``: ``api.scalapack.dlaf_pspotrf(uplo, n, a, 1, 1, desc,
ctx)``, the ScaLAPACK drop-in, on a 1x1 context with the whole matrix as a
host numpy array (the port's convention for every rank).

Set-up makes the input on the card, copies it to the host once, creates
the grid context and the ScaLAPACK descriptor (desc[9]: DTYPE_, CTXT_, M_,
N_, MB_, NB_, RSRC_, CSRC_, LLD_). Each call hands the same array to the
entry, which returns a new array: the factor in the ``uplo`` triangle, the
other triangle as the input had it.
"""
from __future__ import annotations

import numpy as np

CHECK = "cholesky"


def prepare(p: dict, a):
    from dlaf_tpu_torch.api import scalapack
    n, nb = int(p["n"]), int(p["nb"])
    ctx = scalapack.dlaf_create_grid(1, 1)
    desc = np.array([1, ctx, n, n, nb, nb, 0, 0, n], dtype=np.int64)
    host = a.cpu().numpy()
    return {"a": host, "desc": desc, "ctx": ctx, "n": n, "uplo": p["uplo"],
            "device": a.device}


def call(state):
    from dlaf_tpu_torch.api import scalapack
    kw = {} if state["device"].type == "cuda" else {"device": "cpu"}
    return scalapack.dlaf_pspotrf(state["uplo"], state["n"], state["a"], 1, 1, state["desc"],
                                  state["ctx"], **kw)


def answer(out, p: dict) -> dict:
    return {"factor": out, "uplo": p["uplo"]}
