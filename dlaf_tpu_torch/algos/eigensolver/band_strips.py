"""Banded 'strip' storage for stage 2 (band -> tridiagonal).

PyTorch counterpart of :mod:`dlaf_tpu.algos.eigensolver.band_strips`
(reference ``eigensolver/band_to_tridiag/mc.h:438-662``: stage 2 works on an
O(n*b) band layout). Strip storage is

    strips[s]  =  A[s*b : (s+1)*b,  (s-3)*b : (s+2)*b]      shape (b, 5b)

one dense (b, 5b) slab per block-row holding every stored (lower, r >= c)
entry of that block-row with room for the bulge (bandwidth at most 2b-1
during chasing), zeros elsewhere. Row R of A is contiguous in strip R // b,
so A[R, C] lies at flat offset R*5b + C - (R//b)*b + 3b.

A chase at reflector row i0 touches exactly the window

    G = A[[i0, i0+2b) x [i0-b, i0+b)]

which lives in strips s0..s0+2 (s0 = i0//b) at per-strip column offset
(i0 mod b) + (2-g)*b, g = 0..2. Pieces of G (rows [i0, i0+2b), cols
[i0-b, i0+b)):

    CY = G[:b, :b]    rows I = [i0, i0+b), cols [i0-b, i0)   <- H @ CY
    S  = G[:b, b:]    rows I, cols I (hermitian diag block)  <- H @ S @ H^H
    B  = G[b:, b:]    rows [i0+b, i0+2b), cols I             <- B @ H^H

with the eliminated column y = CY[:, b-1] (first chase of a sweep) or
CY[:, 0] (later chases).

:func:`band_to_tridiag_strips` is the sequential chase and the plain
version of kernel K3 (:mod:`dlaf_tpu_torch.ops.kernels.band2tridiag`).
"""
from __future__ import annotations

import torch

from ...ops.core import ct, mm
from ...ops.householder import householder_vector

STRIP_W = 5  # strip width in units of b: cols [(s-3)*b, (s+2)*b)
COL_BASE = 3  # strip-local column of the diagonal element of its first row


def n_strips(n: int, b: int) -> int:
    """Strip count incl. padding so every chase window is in-bounds."""
    return -(-n // b) + 3


def _strips_of(lower: torch.Tensor, b: int) -> torch.Tensor:
    """Strip storage of an (n, n) matrix whose wanted entries are already
    selected (zeros elsewhere)."""
    n = lower.shape[0]
    ns = n_strips(n, b)
    width = COL_BASE * b + ns * b + 2 * b
    ap = lower.new_zeros((ns * b, width))
    ap[:n, COL_BASE * b:COL_BASE * b + n] = lower
    # strip s = ap[s*b:(s+1)*b, s*b:s*b + 5b]: rows step b*width, columns
    # step b, so one strided view holds all of them
    return ap.as_strided((ns, b, STRIP_W * b), (b * width + b, width, 1)).clone()


def band_to_strips(band_dense: torch.Tensor, b: int) -> torch.Tensor:
    """(n, n) dense hermitian band matrix -> strip storage.

    Only the lower triangle within the band is read.
    """
    return _strips_of(torch.tril(band_dense), b)


def packed_to_strips(a_packed: torch.Tensor, band: int) -> torch.Tensor:
    """Strip storage directly from the stage-1 packed output (band in the
    banded lower triangle of ``a_packed``; reflectors strictly below are
    masked away)."""
    return _strips_of(torch.tril(torch.triu(a_packed, -band)), band)


def strips_extract_tridiag(strips: torch.Tensor, n: int, b: int):
    """(d, e) of the tridiagonal matrix left in strip storage."""
    ns = strips.shape[0]
    i = torch.arange(b, device=strips.device)
    dfull = strips[:, i, i + COL_BASE * b].reshape(ns * b)       # A[r, r]
    efull = strips[:, i, i + COL_BASE * b - 1].reshape(ns * b)   # A[r, r-1]
    d = dfull[:n].real if dfull.is_complex() else dfull[:n]
    return d, efull[1:n]


def _chase_window(strips: torch.Tensor, i0: int, b: int):
    """Gather the (2b, 2b) window G at reflector row i0 plus the raw 3-strip
    slab (for the write-back) and the slab row offset."""
    s0, im = divmod(i0, b)
    s3 = torch.cat([strips[s0 + g, :, im + (2 - g) * b:im + (4 - g) * b]
                    for g in range(3)], dim=0)                   # (3b, 2b)
    return s3[im:im + 2 * b], s3, im


def _chase_scatter(strips: torch.Tensor, g_new, s3, im: int, i0: int, b: int) -> None:
    """Write the updated window back into strip storage, in place."""
    s0 = i0 // b
    s3 = s3.clone()
    s3[im:im + 2 * b] = g_new
    for g in range(3):
        strips[s0 + g, :, im + (2 - g) * b:im + (4 - g) * b] = s3[g * b:(g + 1) * b]


def chase_math(g_: torch.Tensor, first: bool, b: int):
    """One bulge-chase on the dense window ``g_`` (2b, 2b).

    Returns (g_new, v, tau). ``first`` selects the eliminated column
    (j = i0-1 for the first chase of a sweep, j = i0-b afterwards).
    """
    y_col = b - 1 if first else 0
    v, tau, beta = householder_vector(g_[:b, y_col])
    vc = v.conj()
    ctau = tau.conj()

    cy = g_[:b, :b]
    s_ = g_[:b, b:]
    b_ = g_[b:, b:]
    s_full = s_ + ct(torch.tril(s_, -1))

    cy = cy - tau * v[:, None] * mm(vc[None, :], cy)
    # eliminated column: beta at the head, zeros below (LAPACK larfg exact)
    cy[:, y_col] = 0
    cy[0, y_col] = beta

    s1 = s_full - tau * v[:, None] * mm(vc[None, :], s_full)
    s2 = s1 - ctau * mm(s1, v[:, None]) * vc[None, :]
    b2 = b_ - ctau * mm(b_, v[:, None]) * vc[None, :]

    g_new = torch.cat([torch.cat([cy, torch.tril(s2)], dim=1),
                       torch.cat([g_[b:, :b], b2], dim=1)], dim=0)
    return g_new, v, tau


def band_to_tridiag_strips(strips: torch.Tensor, n: int, b: int, sweep_lo: int = 0,
                           sweep_chunk: int | None = None):
    """Sequential bulge chasing on strip storage (a copy; ``strips`` is not
    written).

    Returns (d, e, vs, taus) with vs (nsweeps, ncmax, b), taus
    (nsweeps, ncmax); the chase-c reflector of sweep s acts on rows
    [s + 1 + c*b, s + 1 + (c+1)*b). Slots no chase visits hold zeros.

    With ``sweep_chunk`` only sweeps [sweep_lo, sweep_lo + sweep_chunk) are
    *recorded* (vs/taus leading dim = sweep_chunk); the chasing itself
    always runs all sweeps.
    """
    strips = strips.clone()
    nsweeps = n - 2
    ncmax = -(-(n - 1) // b)
    nrec = nsweeps if sweep_chunk is None else sweep_chunk
    vs = strips.new_zeros((nrec + 1, ncmax, b))      # last row = discard slot
    taus = strips.new_zeros((nrec + 1, ncmax))
    for s in range(max(nsweeps, 0)):
        srec = s - sweep_lo if 0 <= s - sweep_lo < nrec else nrec
        for c in range(-(-(n - 1 - s) // b)):
            i0 = s + 1 + c * b
            g_, s3, im = _chase_window(strips, i0, b)
            g_new, v, tau = chase_math(g_, c == 0, b)
            _chase_scatter(strips, g_new, s3, im, i0, b)
            vs[srec, c] = v
            taus[srec, c] = tau
    d, e = strips_extract_tridiag(strips, n, b)
    return d, e, vs[:nrec], taus[:nrec]


def restripe(strips_nb: torch.Tensor, nb: int, b: int, ns_out: int) -> torch.Tensor:
    """nb-strip storage -> b-strip storage (b | nb), a new tensor; the
    replicated O(n*b) pass between stage 1 on nb tiles and a stage 2 that
    chases a band of width b < nb (reference ``get_1d_block_size.h:19-21``).

    b-strip s starts at row r0 = s*b, inside nb-strip t = r0 // nb at row
    r0 % nb; its column 0, global (s-3)*b, is column r0 % nb + 3(nb - b)
    of strip t. A start past the last nb-strip reads that strip, which is
    zero padding, as JAX's clamped ``dynamic_slice`` does.
    """
    if nb % b:
        raise ValueError(f"restripe needs b | nb, got nb={nb}, b={b}")
    out = strips_nb.new_zeros((ns_out, b, STRIP_W * b))
    for s in range(ns_out):
        t, rl0 = divmod(s * b, nb)
        t = min(t, strips_nb.shape[0] - 1)
        c0 = rl0 + 3 * (nb - b)
        out[s] = strips_nb[t, rl0:rl0 + b, c0:c0 + STRIP_W * b]
    return out


# ---------------------------------------------------------------------------
# wavefront (pipelined) chasing: the schedule of the compute-distributed
# stage 2 (reference SweepWorkerDist handoff,
# eigensolver/band_to_tridiag/mc.h:568-661).
#
# Chase (s, c) runs at wavefront time t = 3s + c. Concurrent chases then
# differ in i0 = s + 1 + c*b by multiples of 3b-1, so their (2b x 2b)
# windows are element-disjoint, and every ordered pair of overlapping
# chases runs in the sequential order: the pipelined result is
# bit-identical to the sequential sweep loop.


def wavefront_nsteps(n: int, b: int) -> int:
    nsweeps = max(n - 2, 1)
    ncmax = -(-(n - 1) // b)
    return 3 * (nsweeps - 1) + ncmax


def wavefront_k(S: int, b: int) -> int:
    """Upper bound on concurrent chases inside a segment of S strips."""
    return (S * b) // (3 * b - 1) + 2


def wavefront_chases(t: int, *, n: int, b: int, S: int, seg0: int, K: int):
    """The chases (s, c, i0) of wavefront step ``t`` whose reflector row i0
    lies in strip rows [seg0*b, (seg0+S)*b), as JAX's K-slot loop visits
    them (its masked slots left out)."""
    lo, hi = seg0 * b, (seg0 + S) * b
    # i0(s) = t*b + 1 + s*(1 - 3b) decreases in s: the smallest active s
    # satisfies i0 < hi
    s_min = (t * b + 1 - hi) // (3 * b - 1) + 1
    out = []
    for s in range(s_min, s_min + K):
        c = t - 3 * s
        i0 = s + 1 + c * b
        if 0 <= s < n - 2 and 0 <= c < -(-(n - 1 - s) // b) and lo <= i0 < hi:
            out.append((s, c, i0))
    return out


def chase_wavefront_step(ext: torch.Tensor, vs: torch.Tensor, taus: torch.Tensor, t: int, *,
                         n: int, b: int, S: int, seg0: int, K: int) -> None:
    """Run every wavefront-``t`` chase whose i0 lies in strip rows
    [seg0*b, (seg0+S)*b) on the extended local strip array ``ext``
    ((S+2, b, 5b): strips seg0 .. seg0+S+1, the last two a right halo),
    in place.

    Reflectors are recorded segment-locally: sweep s's chases in this
    segment land at vs[s, c - c_lo(s)] with c_lo(s) = max(0, seg0 - (s+1)//b).
    """
    for s, c, i0 in wavefront_chases(t, n=n, b=b, S=S, seg0=seg0, K=K):
        i0l = i0 - seg0 * b
        g_, s3, im = _chase_window(ext, i0l, b)
        g_new, v, tau = chase_math(g_, c == 0, b)
        _chase_scatter(ext, g_new, s3, im, i0l, b)
        crec = c - max(0, seg0 - (s + 1) // b)
        vs[s, crec] = v
        taus[s, crec] = tau


def band_to_tridiag_wavefront(strips: torch.Tensor, n: int, b: int):
    """One-device wavefront-scheduled chase: the result of
    :func:`band_to_tridiag_strips`, bit for bit, on the t = 3s + c
    schedule that the distributed chase runs per segment."""
    ns = strips.shape[0]
    nsweeps = n - 2
    ncmax = -(-(n - 1) // b)
    ext = torch.cat([strips, strips.new_zeros((2, b, STRIP_W * b))])
    vs = strips.new_zeros((nsweeps, ncmax, b))
    taus = strips.new_zeros((nsweeps, ncmax))
    K = wavefront_k(ns, b)
    for t in range(wavefront_nsteps(n, b)):
        chase_wavefront_step(ext, vs, taus, t, n=n, b=b, S=ns, seg0=0, K=K)
    d, e = strips_extract_tridiag(ext[:ns], n, b)
    return d, e, vs, taus
