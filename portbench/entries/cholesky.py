"""Entry ``cholesky``: ``algos.cholesky.cholesky(dm, uplo)`` on a 1x1 grid.

The input becomes the program's ``DistMatrix`` once, in set-up; each call
factors it (``donate=False``: the call works on its own copy, so the same
input serves every call) and returns a new ``DistMatrix``.
"""
from __future__ import annotations

CHECK = "cholesky"


def prepare(p: dict, a):
    from dlaf_tpu_torch.comm.mesh import Grid
    from dlaf_tpu_torch.matrix.dist_matrix import DistMatrix
    return {"dm": DistMatrix.from_global(a, int(p["nb"]), Grid((1, 1))), "uplo": p["uplo"]}


def call(state):
    from dlaf_tpu_torch.algos.cholesky import cholesky
    return cholesky(state["dm"], uplo=state["uplo"])


def answer(out, p: dict) -> dict:
    n = int(p["n"])
    return {"factor": out.data[:n, :n], "uplo": p["uplo"]}
