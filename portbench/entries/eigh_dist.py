"""Entry ``eigh_dist``: ``algos.eigensolver.dist_driver.eigh_dist(dm)`` on a
1x1 grid, every eigenvalue and eigenvector (stages 1-5 and the final
exchange into the block-cyclic layout).

The input becomes the program's ``DistMatrix`` once, in set-up; the call
does not write it, so the same input serves every call.
"""
from __future__ import annotations

CHECK = "eigh"


def prepare(p: dict, a):
    from dlaf_tpu_torch.comm.mesh import Grid
    from dlaf_tpu_torch.matrix.dist_matrix import DistMatrix
    return {"dm": DistMatrix.from_global(a, int(p["nb"]), Grid((1, 1)))}


def call(state):
    from dlaf_tpu_torch.algos.eigensolver.dist_driver import eigh_dist
    return eigh_dist(state["dm"])


def answer(out, p: dict) -> dict:
    n = int(p["n"])
    w, v = out
    return {"w": w[:n], "v": v.data[:n, :n]}
