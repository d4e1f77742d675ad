"""Matrix printing helpers.

Counterpart of :mod:`dlaf_tpu.matrix.printing`, with the same text. Analog
of the reference's ``matrix/print_numpy.h:116`` / ``print_csv.h:80``:
emit a (distributed) matrix as a numpy-parsable expression or CSV rows, for
debugging and test triage. A ``DistMatrix`` is gathered collectively:
every rank of its grid calls the printer, and rank 0 writes.
"""
from __future__ import annotations

import sys

import numpy as np
import torch


def _gather(a):
    """(the host array, whether this rank writes)."""
    writes = True
    if hasattr(a, "to_global"):
        writes = a.grid.size == 1 or a.grid.rank == 0
        a = a.to_global()
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.asarray(a), writes


def print_numpy(a, name: str = "mat", file=None) -> None:
    """``name = np.array([...])`` — same contract as the reference's
    format_numpy printer."""
    file = file or sys.stdout
    arr, writes = _gather(a)
    if not writes:
        return
    with np.printoptions(threshold=np.inf, linewidth=np.inf,
                         precision=None, floatmode="unique"):
        body = np.array2string(arr, separator=", ")
    print(f"{name} = np.array({body})", file=file)


def print_csv(a, file=None, sep: str = ",") -> None:
    file = file or sys.stdout
    arr, writes = _gather(a)
    if not writes:
        return
    for row in np.atleast_2d(arr):
        print(sep.join(repr(x) for x in row), file=file)
