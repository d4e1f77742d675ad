"""Hermitian eigensolver driver: the full two-stage pipeline.

PyTorch counterpart of :mod:`dlaf_tpu.algos.eigensolver.driver` (reference
``Eigensolver<B,D,T>::call``, ``eigensolver/eigensolver/impl.h:38-95``):

    reduction_to_band -> band_to_tridiag -> tridiagonal D&C
        -> bt_band_to_tridiag -> bt_reduction_to_band

The generalized driver ``eigh_gen`` needs the local TRSM, which is not
ported yet.
"""
from __future__ import annotations

import torch

from ...ops.core import ct
from ...tune import get_tune_parameters
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

    npad = (-n) % b
    if npad:
        # decoupled padding: a large separated diagonal, so the padded
        # eigenvalues sort strictly last (the +1 keeps them above the
        # Gershgorin bound even for an all-zero input)
        ap = a.new_zeros((n + npad, n + npad))
        ap[:n, :n] = a
        gersh = a.abs().max() * (n + 1)
        rdt = _real(ap).dtype
        ap.diagonal()[n:] = gersh + 1.0 + torch.arange(npad, dtype=rdt, device=a.device)
    else:
        ap = a

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
