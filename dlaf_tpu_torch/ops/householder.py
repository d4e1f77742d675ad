"""Householder panel factorization, compact-WY T factor, triangular inverse.

PyTorch counterpart of :mod:`dlaf_tpu.ops.householder`, the building blocks
of the two-stage eigensolver:

  - ``householder_vector``: one reflector with LAPACK ``larfg`` conventions
    (head mapped to the negative real axis by its sign or phase,
    tau = (beta - x0)/beta, v[head] = 1);
  - ``panel_qr``: unblocked Householder QR of an (m, b) panel, a b-step loop
    of vector operations on the shrinking trailing columns;
  - ``t_factor``: T = inv(diag(1/tau) + striu(V^H V)), one GEMM plus a small
    triangular inverse;
  - ``tri_inv``: recursive blocked triangular inverse.

Every function takes leading batch dimensions where the JAX package vmaps
it (``householder_vector``, ``t_factor``, ``tri_inv``).
"""
from __future__ import annotations

import torch

from .core import mm


def _sign_phase(x0: torch.Tensor) -> torch.Tensor:
    """Phase factor of the Householder head: real sign / complex phase
    (maps x0 to the negative real axis like LAPACK larfg)."""
    if x0.is_complex():
        mag = x0.abs()
        return torch.where(mag == 0, torch.ones_like(x0),
                           x0 / torch.where(mag == 0, torch.ones_like(mag), mag))
    return torch.where(x0 >= 0, 1.0, -1.0).to(x0.dtype)


def householder_vector(x: torch.Tensor, head: int = 0):
    """Reflector (v, tau, beta) with H x = beta e_head, v[head] = 1, over the
    last dimension of ``x`` (leading dimensions are a batch).

    ``x`` entries before ``head`` are ignored (taken as zero). Where the
    vector is zero (no reflector) tau = 0, beta = x[head] and v is x with a
    unit head, as in the JAX function.
    """
    n = x.shape[-1]
    xm = x
    if head:
        xm = torch.where(torch.arange(n, device=x.device) >= head, x, torch.zeros_like(x))
    x0 = xm[..., head]
    normx = torch.linalg.vector_norm(xm, dim=-1)
    beta = -_sign_phase(x0) * normx.to(x.dtype)
    denom = x0 - beta
    safe = denom != 0
    v = xm / torch.where(safe, denom, torch.ones_like(denom)).unsqueeze(-1)
    v[..., head] = 1
    tau = torch.where(safe, (beta - x0) / beta, torch.zeros_like(beta))
    return v, tau, torch.where(safe, beta, x0)


def panel_qr(panel: torch.Tensor):
    """Householder QR of an (m, b) panel.

    Returns (v, taus, r): ``v`` (m, b) unit-lower-trapezoidal reflectors
    (ones on the diagonal, zeros above), ``taus`` (b,), ``r`` (min(m, b), b)
    upper triangular factor. Step t reflects rows [t, m) of column t and
    applies the reflector to columns [t, b) only: the JAX function's masks
    select the same entries on full-size arrays.
    """
    m, b = panel.shape
    a = panel.clone()
    v = torch.zeros_like(panel)
    taus = panel.new_zeros((b,))
    for t in range(min(m, b)):
        vt, tau, beta = householder_vector(a[t:, t])
        w = mm(vt.conj()[None, :], a[t:, t:])                  # v^H A  (1, b - t)
        a[t:, t:] -= (tau * vt)[:, None] * w
        a[t, t] = beta
        a[t + 1:, t] = 0
        v[t:, t] = vt
        taus[t] = tau
    return v, taus, torch.triu(a[:b])


def tri_inv(a: torch.Tensor, lower: bool = True, nb: int = 64) -> torch.Tensor:
    """Inverse of a triangular matrix by blocked recursion:
    inv([[A,0],[B,C]]) = [[iA,0],[-iC B iA, iC]]. Only the ``lower`` (or
    upper) triangle of ``a`` is read; the result is a new tensor. Leading
    dimensions of ``a`` are a batch."""
    n = a.shape[-1]
    if n <= nb:
        eye = torch.eye(n, dtype=a.dtype, device=a.device)
        return torch.linalg.solve_triangular(a, eye, upper=not lower)
    n1 = max(n // (2 * nb), 1) * nb
    out = torch.zeros_like(a)
    ia = tri_inv(a[..., :n1, :n1], lower, nb)
    ic = tri_inv(a[..., n1:, n1:], lower, nb)
    out[..., :n1, :n1] = ia
    out[..., n1:, n1:] = ic
    if lower:
        out[..., n1:, :n1] = -mm(ic, mm(a[..., n1:, :n1], ia))
    else:
        out[..., :n1, n1:] = -mm(ia, mm(a[..., :n1, n1:], ic))
    return out


def t_factor(v: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """Compact-WY T (upper triangular, b x b) with Q = I - V T V^H.

    Closed form T^{-1} = diag(1/tau) + striu(V^H V). Columns with tau == 0
    (no reflector) give zero rows and columns in T. ``v`` (..., m, b) and
    ``taus`` (..., b) may carry a batch.
    """
    g = mm(v.mH, v)                                            # V^H V
    safe_tau = torch.where(taus == 0, torch.ones_like(taus), taus)
    tinv = torch.triu(g, 1) + torch.diag_embed(1.0 / safe_tau)
    t = tri_inv(tinv, lower=False, nb=64)
    active = taus != 0
    return torch.where(active[..., :, None] & active[..., None, :], t, torch.zeros_like(t))
