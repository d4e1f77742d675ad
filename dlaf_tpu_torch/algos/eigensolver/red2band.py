"""Stage 1: reduction of a hermitian matrix to band form.

PyTorch counterpart of :mod:`dlaf_tpu.algos.eigensolver.red2band`
(reference ``eigensolver/reduction_to_band/impl.h:968-1109``, local):
blocked Householder panels of width ``band`` and the compact-WY two-sided
trailing update (W = A V T, X = W - 1/2 V T^H V^H W,
A <- A - V X^H - X V^H), with the panel QR and the closed-form T factor of
:mod:`dlaf_tpu_torch.ops.householder`.

Output follows the LAPACK/reference packing: the band stays in the banded
lower triangle of ``a``; the Householder vectors overwrite the annihilated
entries strictly below the band (unit head implicit); ``taus`` (one per
eliminated column) are returned separately (reference ``mat_taus``).
"""
from __future__ import annotations

import torch

from ...ops.core import ct, mm, symmetrize_tri
from ...ops.householder import panel_qr, t_factor


def reduction_to_band(a: torch.Tensor, band: int):
    """Reduce hermitian ``a`` (lower triangle stored, n divisible by band)
    to band form. Returns (a_packed, taus) with taus shaped (n,); ``a`` is
    not written.

    Each panel works on its exact trailing window A[r0:, r0:]: the JAX
    package groups the panels into a few shrinking windows only to keep
    XLA's shapes static, which eager PyTorch does not need. The trailing
    window is kept fully hermitian (symmetrized once on entry), so
    W = A (V T) needs no masking, and the rank-2b update V X^H + X V^H is
    one GEMM, [V X] [X V]^H, subtracted in place.
    """
    n = a.shape[0]
    b = band
    if n % b:
        raise ValueError(f"reduction_to_band needs n % band == 0, got n={n}, band={b}")
    a = symmetrize_tri(a, lower=True)
    taus = a.new_zeros((n,))
    for k in range(max(n // b - 1, 0)):
        j0 = k * b                           # panel columns [j0, j0 + b)
        r0 = j0 + b                          # reflector rows [r0, n)
        v, taus_p, r_fac = panel_qr(a[r0:, j0:r0])
        t = t_factor(v, taus_p)
        win = a[r0:, r0:]
        w = mm(win, mm(v, t))
        x = w - 0.5 * mm(v, mm(ct(t), mm(ct(v), w)))
        win -= mm(torch.cat([v, x], dim=1), ct(torch.cat([x, v], dim=1)))
        # R on the band block, V strictly below each column's head row
        newpanel = torch.tril(v, -1)
        newpanel[:b] += r_fac
        a[r0:, j0:r0] = newpanel
        taus[j0:r0] = taus_p
    return a, taus


def extract_band(a_packed: torch.Tensor, band: int) -> torch.Tensor:
    """Dense hermitian band matrix from the packed output (both triangles)."""
    lower_band = torch.tril(torch.triu(a_packed, -band))
    return lower_band + ct(torch.tril(lower_band, -1))


def extract_v(a_packed: torch.Tensor, band: int) -> torch.Tensor:
    """Householder panels (strictly below the band) with unit heads restored.

    Returns v (n, n) where column j holds the reflector that eliminated
    column j (head at row j + band, implicit 1 set explicitly).
    """
    n = a_packed.shape[0]
    v = torch.tril(a_packed, -band - 1)
    idx = torch.arange(band, n, device=a_packed.device)
    v[idx, idx - band] = 1
    return v
