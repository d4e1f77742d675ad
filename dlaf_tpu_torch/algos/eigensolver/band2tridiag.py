"""Stage 2: band -> tridiagonal via Householder bulge chasing.

PyTorch counterpart of :mod:`dlaf_tpu.algos.eigensolver.band2tridiag`
(reference ``eigensolver/band_to_tridiag/mc.h:438-990``): sweep s eliminates
column s below the first subdiagonal, then chases the fill-in bulge down in
steps of the bandwidth. Every reflector (length ``b``) is recorded, the
analog of the reference's ``TridiagResult::hh_reflectors``, so that the
back-transformation can apply it to the eigenvectors later.

Three routes compute the same (d, e, vs, taus):

  - :func:`band_to_tridiag`: the dense sequential chase on a full hermitian
    matrix padded by ``3b+2`` on each side;
  - :func:`band_to_tridiag_pipelined`: the same chases, sweeps ``LAG``
    chase-steps apart, every chase of one time step as one batched
    operation (the CPU route);
  - the strip-storage chase of :mod:`.band_strips`, sequential in plain
    PyTorch or on the card through kernel K3
    (:mod:`dlaf_tpu_torch.ops.kernels.band2tridiag`).

:func:`band_to_tridiag_auto` picks one by ``band_to_tridiag_kernel``.
"""
from __future__ import annotations

import torch

from ...ops.core import mm
from ...ops.householder import householder_vector
from ...ops.kernels import _build
from ...ops.kernels.band2tridiag import band_to_tridiag_strips_kernel, chaser_feasible
from ...tune import get_tune_parameters
from .band_strips import band_to_strips, band_to_tridiag_strips


def _trivial(band_dense: torch.Tensor, b: int):
    d = torch.diagonal(band_dense)
    d = d.real if d.is_complex() else d
    vs = band_dense.new_zeros((1, 1, b))
    taus = band_dense.new_zeros((1, 1))
    return d, torch.diagonal(band_dense, -1), vs, taus


def _padded(band_dense: torch.Tensor, b: int):
    n = band_dense.shape[0]
    pad = 3 * b + 2
    a = band_dense.new_zeros((n + 2 * pad, n + 2 * pad))
    a[pad:pad + n, pad:pad + n] = band_dense
    return a, pad


def _tridiag_of(a: torch.Tensor, pad: int, n: int):
    full = a[pad:pad + n, pad:pad + n]
    d = torch.diagonal(full)
    return (d.real if d.is_complex() else d), torch.diagonal(full, -1)


def band_to_tridiag(band_dense: torch.Tensor, b: int):
    """Reduce a dense hermitian band matrix (bandwidth ``b``) to tridiagonal.

    Returns (d, e, vs, taus): diagonal (n,), subdiagonal (n-1,), recorded
    reflectors vs (nsweeps, ncmax, b) and taus (nsweeps, ncmax) where the
    chase-c reflector of sweep s acts on rows [s + 1 + c*b, s + 1 + (c+1)*b).
    """
    n = band_dense.shape[0]
    if b == 1 or n <= 2:
        return _trivial(band_dense, b)
    a, pad = _padded(band_dense, b)
    nsweeps = n - 2
    ncmax = -(-(n - 1) // b)
    win = 3 * b + 2
    vs = band_dense.new_zeros((nsweeps, ncmax, b))
    taus = band_dense.new_zeros((nsweeps, ncmax))
    for s in range(nsweeps):
        for c in range(-(-(n - 1 - s) // b)):
            i0 = s + 1 + c * b + pad              # reflector rows [i0, i0 + b)
            j = (s if c == 0 else s + 1 + (c - 1) * b) + pad   # column to clean
            v, tau, beta = householder_vector(a[i0:i0 + b, j])
            a[i0:i0 + b, j] = 0
            a[i0, j] = beta
            a[j, i0:i0 + b] = a[i0:i0 + b, j].conj()
            # two-sided windowed update on cols/rows (j, j + win]
            srow = a[i0:i0 + b, j + 1:j + 1 + win]
            srow -= (tau * v)[:, None] * mm(v.conj()[None, :], srow)
            scol = a[j + 1:j + 1 + win, i0:i0 + b]
            scol -= tau.conj() * mm(scol, v[:, None]) * v.conj()[None, :]
            vs[s, c] = v
            taus[s, c] = tau
    d, e = _tridiag_of(a, pad, n)
    return d, e, vs, taus


LAG = 4  # chase-steps between adjacent active sweeps (> window extent / b)


def band_to_tridiag_pipelined(band_dense: torch.Tensor, b: int):
    """Wavefront-pipelined bulge chasing: the mathematics and reflector
    record of :func:`band_to_tridiag`, with sweeps LAG chase-steps apart so
    that up to ncmax/LAG chases run per step as one batched operation.

    Disjointness: lane w works on rows [i0_w, i0_w + b), window columns
    (j_w, j_w + 3b + 2]; adjacent active lanes are LAG*b - 1 >= 3b + 2 rows
    apart (b >= 3), so the batched gathers and scatters of one step touch
    disjoint entries. Invalid lanes are pointed at the top-left zero
    padding, which no valid window touches, with tau = 0: their writes
    store back what they read. (The JAX function's ``lane_chunk``, which
    caps the lanes per batched scatter on the TPU and which no caller sets,
    is not carried over.)
    """
    n = band_dense.shape[0]
    dt_ = band_dense.dtype
    if b == 1 or n <= 2 or b < 3:
        return band_to_tridiag(band_dense, b)
    a, pad = _padded(band_dense, b)
    dev = a.device
    nsweeps = n - 2
    ncmax = -(-(n - 1) // b)
    win = 3 * b + 2
    nlanes = ncmax // LAG + 1
    tsteps = LAG * (nsweeps - 1) + ncmax + 1
    vs = band_dense.new_zeros((nsweeps + 1, ncmax, b))     # last row = discard
    taus = band_dense.new_zeros((nsweeps + 1, ncmax))
    ar_b = torch.arange(b, device=dev)
    ar_w = torch.arange(win, device=dev)
    lanes = torch.arange(nlanes, device=dev)
    for t in range(tsteps):
        s_w = t // LAG - lanes
        c_w = t - LAG * s_w
        nc_w = torch.clamp(-((-(n - 1 - s_w)) // b), min=0)
        valid = (s_w >= 0) & (s_w < nsweeps) & (c_w < nc_w)
        i0 = s_w + 1 + c_w * b
        j = torch.where(c_w == 0, s_w, s_w + 1 + (c_w - 1) * b)
        i0p = torch.where(valid, i0 + pad, 0)
        jp = torch.where(valid, j + pad, 0)
        w0 = jp + 1
        rows = i0p[:, None] + ar_b[None, :]                 # (W, b)
        x = a[rows, jp[:, None]]
        v, tau, beta = householder_vector(x)
        tau = torch.where(valid, tau, torch.zeros_like(tau))
        v = torch.where(valid[:, None], v, torch.zeros_like(v))
        # eliminated column + hermitian mirror
        newcol = torch.where(ar_b[None, :] == 0, beta[:, None], torch.zeros_like(x))
        newcol = torch.where(valid[:, None], newcol, x)
        a[rows, jp[:, None]] = newcol
        a[jp[:, None], rows] = newcol.conj()
        # two-sided windowed update, rows then columns
        wcols = w0[:, None] + ar_w[None, :]                 # (W, win)
        ri, ci = rows[:, :, None], wcols[:, None, :]
        srow = a[ri, ci]                                    # (W, b, win)
        vhs = torch.einsum("wb,wbc->wc", v.conj(), srow)
        a[ri, ci] = srow - tau[:, None, None] * v[:, :, None] * vhs[:, None, :]
        scol = a[ci.transpose(1, 2), ri.transpose(1, 2)]    # (W, win, b)
        sv = torch.einsum("wcb,wb->wc", scol, v)
        a[ci.transpose(1, 2), ri.transpose(1, 2)] = \
            scol - tau.conj()[:, None, None] * sv[:, :, None] * v.conj()[:, None, :]
        s_idx = torch.where(valid, s_w, nsweeps)
        c_idx = torch.clamp(c_w, 0, ncmax - 1)
        vs[s_idx, c_idx] = v
        taus[s_idx, c_idx] = tau
    d, e = _tridiag_of(a, pad, n)
    return d, e, vs[:nsweeps], taus[:nsweeps]


def band_to_tridiag_auto(band_dense: torch.Tensor, b: int):
    """Route selection per ``tune.band_to_tridiag_kernel``.

    "auto" runs kernel K3 on a CUDA tensor of f32 or complex64 with
    8 <= b <= 384, the plain strip chase on any other CUDA tensor (f64 and
    complex128, as the JAX package runs emulated f64 on the TPU), and the
    batched dense pipelined chase on a CPU tensor. "kernel" insists on K3
    and raises where it cannot run; "strips", "pipelined" and "sequential"
    name a plain route.
    """
    kind = get_tune_parameters().band_to_tridiag_kernel
    n = band_dense.shape[0]
    if kind == "sequential":
        return band_to_tridiag(band_dense, b)
    if kind == "pipelined":
        return band_to_tridiag_pipelined(band_dense, b)
    if b == 1 or n <= 2:
        return band_to_tridiag(band_dense, b)
    on_card = _build.on_cuda(band_dense)
    ok = chaser_feasible(b, band_dense.dtype)
    if kind == "kernel" and not (on_card and ok):
        raise ValueError(
            "band_to_tridiag_kernel='kernel' needs a CUDA tensor of f32/complex64 "
            f"and 8 <= b <= 384 (got device={band_dense.device}, "
            f"dtype={band_dense.dtype}, b={b}); use 'auto' or 'strips'")
    if kind == "strips" or (on_card and not ok):
        return band_to_tridiag_strips(band_to_strips(band_dense, b), n, b)
    if on_card:
        return band_to_tridiag_strips_kernel(band_to_strips(band_dense, b), n, b)
    return band_to_tridiag_pipelined(band_dense, b)
