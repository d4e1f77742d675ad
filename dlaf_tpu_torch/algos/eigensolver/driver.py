"""Hermitian eigensolver driver: the full two-stage pipeline.

PyTorch counterpart of :mod:`dlaf_tpu.algos.eigensolver.driver` (reference
``Eigensolver<B,D,T>::call``, ``eigensolver/eigensolver/impl.h:38-95``):

    reduction_to_band -> band_to_tridiag -> tridiagonal D&C
        -> bt_band_to_tridiag -> bt_reduction_to_band

plus the generalized driver ``eigh_gen`` (``GenEigensolver::call``,
``eigensolver/gen_eigensolver/impl.h:30-93``):

    potrf(B) -> generalized_to_standard -> eigh -> TRSM back-substitution.
"""
from __future__ import annotations

import torch

from ...api import local as lapi
from ...ops.core import ct
from ...tune import get_tune_parameters
from ..gen_to_std import generalized_to_standard
from .band2tridiag import band_to_tridiag_auto as band_to_tridiag
from .bt import bt_band_to_tridiag, bt_reduction_to_band
from .red2band import extract_band, reduction_to_band
from .tridiag_dc import tridiag_eigh


def get_band_size(nb: int) -> int:
    """Smallest divisor of nb >= eigensolver_min_band (reference
    ``eigensolver/internal/get_band_size.h:20`` getBandSize)."""
    min_band = get_tune_parameters().eigensolver_min_band
    for cand in range(min_band, nb + 1):
        if nb % cand == 0:
            return cand
    return nb


def _real(x: torch.Tensor) -> torch.Tensor:
    return x.real if x.is_complex() else x


def pad_diagonal(amax: torch.Tensor, n: int, k: torch.Tensor) -> torch.Tensor:
    """The decoupled padding of an n x n matrix A (amax = max|A|): the
    diagonal entry at n + k (k an integer tensor) is (n + 1) amax + 1 + k,
    above the Gershgorin bound (the +1 even for an all-zero A), so the
    padded eigenvalues are separated and sort strictly last."""
    return amax * (n + 1) + 1.0 + k.to(amax.dtype)


def pad_dense(a: torch.Tensor, m: int) -> torch.Tensor:
    """``a`` (n x n) embedded in an m x m matrix, zero off its block, with
    :func:`pad_diagonal` on the padding diagonal; ``a`` itself if m == n."""
    n = a.shape[0]
    if m == n:
        return a
    ap = a.new_zeros((m, m))
    ap[:n, :n] = a
    ap.diagonal()[n:] = pad_diagonal(a.abs().max(), n, torch.arange(m - n, device=a.device))
    return ap


def eigh(a: torch.Tensor, uplo: str = "L", band: int | None = None,
         laed4_iter: int | None = None):
    """Eigenvalues (ascending) and eigenvectors of hermitian ``a``.

    Reference: ``dlaf::hermitian_eigensolver`` (``eigensolver/eigensolver.h:56``).
    Only the ``uplo`` triangle of ``a`` is referenced, and ``a`` is not
    written. Returns (w, v) with v's columns the eigenvectors, on a's
    device: stage 2 runs kernel K3 on a CUDA tensor of f32 or complex64.
    """
    n = a.shape[0]
    if uplo == "U":
        a = ct(a)
    if n == 0:
        return a.new_zeros((0,)), a.new_zeros((0, 0))
    if n == 1:
        return _real(a[0:1, 0]).clone(), a.new_ones((1, 1))

    tune = get_tune_parameters()
    laed4 = laed4_iter or tune.laed4_max_iter
    group = tune.bt_band_to_tridiag_hh_apply_group_size

    b = band or get_band_size(tune.default_block_size)
    if n <= b:
        # no bigger than one band block: the dense matrix is the band
        # matrix of bandwidth n - 1, and stage 1 is skipped
        bn = max(n - 1, 1)
        band_dense = torch.tril(a) + ct(torch.tril(a, -1))
        d, e, vs, taus2 = band_to_tridiag(band_dense, bn)
        er, phases = _phase_normalize(e, a.dtype)
        w, q = tridiag_eigh(_real(d), er, laed4)
        q = phases[:, None] * q.to(a.dtype)
        return w, bt_band_to_tridiag(q, vs, taus2, bn, group_size=group)

    ap = pad_dense(a, n + (-n) % b)
    packed, taus1 = reduction_to_band(ap, b)
    d, e, vs, taus2 = band_to_tridiag(extract_band(packed, b), b)
    er, phases = _phase_normalize(e, ap.dtype)
    w, q = tridiag_eigh(_real(d), er, laed4)
    q = phases[:, None] * q.to(ap.dtype)
    q = bt_band_to_tridiag(q, vs, taus2, b, group_size=group)
    q = bt_reduction_to_band(q, packed, taus1, b)
    return w[:n], q[:n, :n]


def _phase_normalize(e: torch.Tensor, dtype):
    """Make the tridiagonal subdiagonal real (hermitian input): with
    phi_0 = 1, phi_{k+1} = phi_k * e_k/|e_k|, T = diag(phi) T_real diag(phi)^H
    has subdiagonal |e|; eigenvectors map back as v = phi * v_real."""
    if not e.is_complex():
        return e, torch.ones((e.shape[0] + 1,), dtype=dtype, device=e.device)
    mag = e.abs()
    sign = torch.where(mag > 0, e / torch.where(mag > 0, mag, 1.0), 1.0)
    phases = torch.cat([torch.ones((1,), dtype=dtype, device=e.device), torch.cumprod(sign, 0)])
    return mag, phases


def eigh_gen(a: torch.Tensor, b: torch.Tensor, uplo: str = "L", factorized: bool = False,
             **kw):
    """Generalized eigenproblem A x = lambda B x (B hermitian positive
    definite): (w, x) with w ascending and X^H B X = I.

    Reference: ``dlaf::hermitian_generalized_eigensolver[_factorized]``
    (``eigensolver/gen_eigensolver.h:182-476``). Only the ``uplo``
    triangles of ``a`` and ``b`` are read. B is factored lower whatever
    ``uplo`` is (K1 on the card's f32 leaves); with ``factorized``, ``b``
    is already the Cholesky factor on the ``uplo`` triangle (an upper
    factor U is used as L = U^H). ``kw`` goes to :func:`eigh` (K3 in its
    stage 2).
    """
    nb = get_tune_parameters().leaf_block_size
    if uplo not in ("L", "U"):
        raise ValueError(f"uplo must be 'L' or 'U', got {uplo!r}")
    if uplo == "U":
        # the lower triangle of A^H (B^H) is the hermitian matrix's lower
        # triangle, built from the stored upper one
        a = ct(a)
        b = ct(b)
    l = b if factorized else lapi.potrf(b, uplo="L", nb=nb)
    astd = generalized_to_standard(a, l, uplo="L", nb=nb)
    w, z = eigh(astd, uplo="L", **kw)
    del astd
    # back-substitution x = L^-H z (reference gen_eigensolver/impl.h:85-91)
    return w, lapi.trsm(l, z, side="L", uplo="L", trans="C", nb=nb)
