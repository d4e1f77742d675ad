"""Plain reference for the eigensolver cells, and the comparison that judges
an eigendecomposition.

The reference eigenvalues are ``torch.linalg.eigvalsh`` of the input in
float64; their largest magnitude is ||A||_2. A decomposition (w, V) of A is
judged in float64 by two numbers:

- ``resid``: max_j ||A v_j - w_j v_j||_2 / ||A||_2, every eigenpair;
- ``orth``: max_ij |(V^H V - I)_ij|, every pair of eigenvectors.

Eigenvectors are unique only up to a sign or phase a column, so they are
judged through ``resid`` and ``orth``, which together hold every (w_j, v_j)
to being an eigenpair of A and all n of them to being distinct: a wrong or
missing eigenvalue shows in both. ``eig_err``, max_i |w_i - w_ref_i| /
||A||_2, is returned beside them for the record and is not compared: at
n = 10240 the program reads 1.1e-4 in f32 and 1.2e-4 to 1.5e-4 with TF32
products, so no limit tells the two apart. This module imports only torch
and numpy.
"""
from __future__ import annotations

import numpy as np
import torch

# columns of the blocks the residual is formed in
COLS = 4096
# numbers returned for the record only, without a limit
RECORDED = ("eig_err",)


def _wide(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.complex128 if t.is_complex() else torch.float64)


def judge(a: torch.Tensor, w, v) -> dict:
    """The numbers of the decomposition (w, v) of ``a`` (numpy arrays or
    tensors; compared on ``a``'s device): ``resid`` and ``orth``, which
    are compared, and ``eig_err``, which is not (:data:`RECORDED`)."""
    dev = a.device
    w = torch.as_tensor(np.asarray(w) if isinstance(w, np.ndarray) else w).to(dev)
    v = torch.as_tensor(np.asarray(v) if isinstance(v, np.ndarray) else v).to(dev)
    n = a.shape[0]
    if tuple(w.shape) != (n,) or tuple(v.shape) != (n, n):
        raise ValueError(f"w {tuple(w.shape)}, v {tuple(v.shape)} for an input of {n}")
    a64 = _wide(a)
    wref = torch.linalg.eigvalsh(a64)
    anorm = float(wref.abs().max())
    w64 = w.to(torch.float64)
    eig_err = float((w64 - wref).abs().max()) / anorm
    del wref
    v64 = _wide(v)
    resid = 0.0
    for c0 in range(0, n, COLS):
        c1 = min(n, c0 + COLS)
        r = a64 @ v64[:, c0:c1] - v64[:, c0:c1] * w64[c0:c1].to(v64.dtype)[None, :]
        resid = max(resid, float(torch.linalg.vector_norm(r, dim=0).max()) / anorm)
        del r
    del a64
    gram = v64.mH @ v64
    gram.diagonal().sub_(1)
    orth = float(gram.abs().max())
    return {"eig_err": eig_err, "resid": resid, "orth": orth}
