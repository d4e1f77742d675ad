"""Plain reference for the Cholesky cells, and the comparison that judges a factor.

The reference factor is ``torch.linalg.cholesky`` of the input in float64.
A factor is judged by two numbers:

- ``factor_err``: the largest, over the rows of the stored triangle, of
  ||L[i, :] - Lref[i, :]||_2 / ||Lref[i, :]||_2 (float64). A row's norm is
  sqrt(A_ii), so every entry of the row counts at its own scale, and a
  trailing update left out or computed in TF32 shows in the rows it
  touched;
- ``other_changed``: the entries of the strict other triangle that are not
  bit-equal to the input's (the call leaves them as they were).

:func:`blocked_cholesky` is the same factorization as a plain right-looking
tiled loop. The control runs it with TF32 products in the program's place.
This module imports only torch and numpy.
"""
from __future__ import annotations

import numpy as np
import torch

# rows of the blocks a factor is judged in (float64 temporaries of
# ROWS x n: 4 GiB at n = 40960 for 12800 rows)
ROWS = 4096


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x)
    return x


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32 if t.element_size() == 4 else torch.int64)


def reference_factor(a: torch.Tensor, uplo: str = "L") -> torch.Tensor:
    """The reference factor in float64: lower L with A = L L^H (for uplo
    "U" the lower factor of A^H, whose conjugate transpose is U)."""
    a64 = (a if uplo == "L" else a.mH).to(torch.complex128 if a.is_complex() else torch.float64)
    return torch.linalg.cholesky(a64)


def judge(a: torch.Tensor, factor, uplo: str = "L") -> dict:
    """The two numbers of a factor of ``a`` (the factor may be a numpy
    array; it is compared in blocks of rows on ``a``'s device)."""
    factor = _as_tensor(factor, a.device)
    n = a.shape[0]
    if tuple(factor.shape) != (n, n):
        raise ValueError(f"factor of shape {tuple(factor.shape)} for an input of {n}")
    if uplo == "U":
        a, factor = a.mH, factor.mH
    changed = 0
    for r0 in range(0, n, ROWS):
        r1 = min(n, r0 + ROWS)
        got = factor[r0:r1].to(a.device)
        strict_upper = torch.ones((r1 - r0, n), dtype=torch.bool, device=a.device).triu_(r0 + 1)
        changed += int((strict_upper & (_bits(got) != _bits(a[r0:r1]))).sum())
    lref = reference_factor(a, "L")
    worst = 0.0
    for r0 in range(0, n, ROWS):
        r1 = min(n, r0 + ROWS)
        got = torch.tril(factor[r0:r1].to(a.device), r0).to(lref.dtype)
        want = lref[r0:r1]
        err = torch.linalg.vector_norm(got - want, dim=1) / torch.linalg.vector_norm(want, dim=1)
        worst = max(worst, float(err.max()))
    del lref
    return {"factor_err": worst, "other_changed": changed}


def blocked_cholesky(a: torch.Tensor, nb: int, uplo: str = "L") -> torch.Tensor:
    """Right-looking tiled Cholesky of ``a`` in its own dtype: each diagonal
    tile by ``torch.linalg.cholesky``, its panel by a triangular solve,
    the trailing lower triangle by ``matmul`` in blocks of ROWS rows.
    Returns a new tensor: the factor in the ``uplo`` triangle, the strict
    other triangle as ``a`` had it."""
    if uplo == "U":
        return blocked_cholesky(a.mH, nb, "L").mH.contiguous()
    n = a.shape[0]
    out = a.clone()
    for k0 in range(0, n, nb):
        k1 = min(n, k0 + nb)
        lkk = torch.linalg.cholesky(torch.tril(out[k0:k1, k0:k1]))
        out[k0:k1, k0:k1] = torch.where(
            torch.ones_like(lkk, dtype=torch.bool).tril(), lkk, out[k0:k1, k0:k1])
        if k1 == n:
            break
        panel = torch.linalg.solve_triangular(lkk.mH, out[k1:, k0:k1], upper=True, left=False)
        out[k1:, k0:k1] = panel
        for r0 in range(k1, n, ROWS):
            r1 = min(n, r0 + ROWS)
            upd = panel[r0 - k1:r1 - k1] @ panel[:r1 - k1].mH
            keep = torch.ones((r1 - r0, r1 - k1), dtype=torch.bool,
                              device=a.device).tril_(r0 - k1)
            out[r0:r1, k1:r1] -= torch.where(keep, upd, 0)
    return out
