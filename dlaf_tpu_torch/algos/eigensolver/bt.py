"""Back-transformations: tridiagonal eigenvectors -> band -> full.

PyTorch counterpart of :mod:`dlaf_tpu.algos.eigensolver.bt`, the
reference's two back-transformations:

  - ``bt_band_to_tridiag`` (``eigensolver/bt_band_to_tridiag/impl.h``):
    applies the bulge-chasing reflectors recorded by stage 2 in reverse
    sweep order, ``group_size`` sweeps' chase-c reflectors at a time as one
    staggered compact-WY block (two GEMMs);
  - ``bt_reduction_to_band`` (``eigensolver/bt_reduction_to_band/impl.h``):
    applies the stage-1 compact-WY panels in reverse panel order,
    E -= V (T (V^H E)).

Convention: the reductions computed A_next = H A H^H per reflector in
creation order, so eigenvectors map back as E <- H_k^H E applied in
reverse creation order.

``eigh_large`` applies stage 2's record through the ``shifted`` branch of
:func:`bt_band_to_tridiag`, kernels K4 and K5 on the card
(:mod:`dlaf_tpu_torch.ops.kernels.bt_apply`).
"""
from __future__ import annotations

import torch

from ...ops.core import ct, mm
from ...ops.householder import t_factor
from ...ops.kernels.bt_apply import bt_apply_feasible, bt_apply_fused, bt_apply_group, fused_groups
from ...tune import get_tune_parameters
from ...types import real_dtype


def bt_band_to_tridiag_sweepwise(e_mat, vs, taus, b: int):
    """E <- Q_stage2 E, one batched rank-1 pass per sweep (the reference's
    ungrouped application; the test oracle of :func:`bt_band_to_tridiag`)."""
    if b == 1:
        return e_mat
    n, nev = e_mat.shape
    nsweeps, ncmax, _ = vs.shape
    # pad rows so the batched per-sweep view [s+1, s+1+ncmax*b) is in-bounds
    ep = torch.cat([e_mat, e_mat.new_zeros((ncmax * b + 1, nev))], dim=0)
    for s in range(nsweeps - 1, -1, -1):
        v, tau = vs[s], taus[s]                            # (ncmax, b), (ncmax,)
        blk3 = ep[s + 1:s + 1 + ncmax * b].view(ncmax, b, nev)
        # w = v^H blk per chase; blk -= conj(tau) v w   (applying H^H)
        w = torch.einsum("cb,cbe->ce", v.conj(), blk3)
        blk3 -= tau.conj()[:, None, None] * v[:, :, None] * w[:, None, :]
    return ep[:n]


def wy_select_tensor(g: int, b: int, dtype):
    """The 0/1 selection tensor of the JAX package's staggered WY trapezoid,
    V[r, j] = vs_rev[j, r - (g-1-j)] = einsum('rjt,jt->rj', SEL, vs_rev),
    shape (b+g-1, g, b). :func:`wy_group_vt` places the same entries by
    index instead of by this contraction."""
    r = torch.arange(b + g - 1)[:, None, None]
    j = torch.arange(g)[None, :, None]
    t = torch.arange(b)[None, None, :]
    return (r == (g - 1 - j) + t).to(real_dtype(dtype))


def wy_group_vt(vs_g, taus_g):
    """Compact-WY (V, T) of one group x chase block.

    vs_g/taus_g: the group's reflectors for one chase index, sweep-ascending
    ((..., g, b) / (..., g)); leading dimensions are a batch (chases). The
    block operator is Q^H with Q = H_{s+g-1} ... H_s (highest sweep applied
    first), so V column j holds sweep s+g-1-j at row offset g-1-j.
    """
    g, b = vs_g.shape[-2:]
    vs_rev = torch.flip(vs_g, dims=[-2])
    taus_rev = torch.flip(taus_g, dims=[-1])
    dev = vs_g.device
    rows = (g - 1 - torch.arange(g, device=dev))[:, None] + torch.arange(b, device=dev)[None, :]
    cols = torch.arange(g, device=dev)[:, None]
    v = vs_g.new_zeros((*vs_g.shape[:-2], b + g - 1, g))
    v[..., rows, cols] = vs_rev
    return v, t_factor(v, taus_rev)


def _group_reflectors(vs, taus, s0: int, g: int, b: int, nc: int, raw_bp: int | None):
    """The reflectors of sweeps [s0, s0 + g), chases [0, nc), chase-major:
    (nc, g, b) with unit heads, and taus (nc, g). A raw record (``raw_bp``,
    the JAX chaser's aliased layout) holds tau in slot 0 of each reflector:
    the head is restored per group (1 where tau != 0, 0 where the slot is
    a no-op), so no cooked copy of the whole record is made."""
    tau_g = taus[s0:s0 + g, :nc]
    if raw_bp is None:
        vs_g = vs[s0:s0 + g, :nc]
    else:
        raw = vs[s0:s0 + g].reshape(g, -1, raw_bp)[:, :nc, :b]
        head = (tau_g != 0).to(raw.dtype)
        vs_g = torch.cat([head[:, :, None], raw[:, :, 1:]], dim=2)
    return vs_g.transpose(0, 1), tau_g.transpose(0, 1)


def _group_vt_all(vs, taus, s0: int, g: int, b: int, nc: int, raw_bp: int | None):
    """(V, V2) slabs of one group for the streaming kernels K4/K5: V
    (nc, 2b, g) the staggered WY trapezoids zero-padded from b + g - 1 to 2b
    rows, and V2 = V T^H prefolded, so that a chase's update is
    W - V2 (V^T W) (JAX ``bt.py _group_vt_all``)."""
    v, t = wy_group_vt(*_group_reflectors(vs, taus, s0, g, b, nc, raw_bp))
    v = torch.cat([v, v.new_zeros((nc, 2 * b - v.shape[1], g))], dim=1)
    return v, mm(v, ct(t))


def _shifted_apply(ep2, vs, taus, b: int, g: int, ngroups: int, ncmax: int, sweep_lo: int,
                   raw_bp: int | None):
    """Stage 4 on the SHIFTED buffer through kernels K4 and K5, in place
    (JAX ``bt.py:192-260``, its index arithmetic kept as it is)."""
    n, nev = ep2.shape
    nmat = n - 2 * b               # buffer rows = (nmat/b + 2) * b
    nbig = nmat // b               # first out-of-band block index
    lo = sweep_lo

    def group_step(k):
        s0 = (ngroups - 1 - k) * g
        # clamp fully-invalid trailing groups (chunked records whose rounded
        # sweep range overshoots nsweeps by >= 2b+2) into the last in-bounds
        # window: their reflectors are all zero (tau == 0), so the clamped
        # blocks are read and written back unchanged; partially valid groups
        # always have abs0 <= nmat - b already. Without the clamp the kernel
        # would read and write past the (nmat + 2b, nev) buffer.
        abs0 = min(lo + s0, max(nmat - b, 0))
        ncvalid = min(max(-(-(nmat - 1 - abs0) // b), 1), ncmax)
        v, v2 = _group_vt_all(vs, taus, s0, g, b, ncvalid, raw_bp)
        bt_apply_group(ep2, v, v2, abs0 // b, ncvalid, b)

    kf = min(fused_groups(nev, b), get_tune_parameters().bt_apply_fuse_groups)
    while kf > ngroups:            # keep >= 1 genuinely fused step
        kf //= 2
    if kf < 2:
        for k in range(ngroups):
            group_step(k)
        return ep2
    # the first ngroups % kf groups (highest sweeps) go through K4; the rest
    # run kf-fused through K5, one pass over E per step
    rpeel = ngroups % kf
    for k in range(rpeel):
        group_step(k)
    for k2 in range((ngroups - rpeel) // kf):
        # the step covers groups gi = gi_top - j, j = 0..kf-1 (application
        # order); geometric phantoms (window base at or past the band end)
        # are the j < jb prefix
        gi_top = ngroups - 1 - rpeel - k2 * kf
        beta = lo // b + gi_top - (kf - 1)     # the TOP group's base block
        nact = min(max(nbig - beta, 0), kf)
        v0p = nbig - beta - nact + 1
        jb = kf - nact
        nsteps = v0p + nact - 1 if nact > 0 else 0
        v = ep2.new_zeros((nsteps, kf, 2 * b, g))
        v2 = torch.zeros_like(v)
        for i in range(nact):          # i = 0 is the bottom valid group
            s0_i = (gi_top - jb - i) * g
            v[:, i], v2[:, i] = _group_vt_all(vs, taus, s0_i, g, b, nsteps, raw_bp)
        bt_apply_fused(ep2, v, v2, beta, nact, v0p, kf, b)
    return ep2


def bt_band_to_tridiag(e_mat, vs, taus, b: int, group_size: int = 64, sweep_lo: int = 0,
                       prepadded: bool = False, raw_bp: int | None = None,
                       shifted: bool = False):
    """E <- Q_stage2 E with grouped compact-WY application.

    ``group_size`` consecutive sweeps' chase-c reflectors form one staggered
    WY block applied with two GEMMs. Blocks run ascending in c, groups
    descending in sweeps: an exact linear extension of the per-reflector
    order. A group's chases past the band end carry no reflector and are
    skipped; its V and T are formed for all of its chases at once.

    With ``sweep_lo`` the record covers absolute sweeps
    [sweep_lo, sweep_lo + vs.shape[0]) (apply chunks in descending
    ``sweep_lo`` order). With ``prepadded`` the caller passes E already
    extended by ``b + group_size - 1`` workspace rows and gets the padded
    buffer back. Returns a new tensor unless ``prepadded`` or ``shifted``,
    which update the given buffer in place.

    With ``raw_bp`` the record is the JAX chaser's raw aliased layout
    (nrec + 1, ncmax * (raw_bp // 128), 128): slot 0 of each reflector holds
    tau and the trailing row is ignored; the unit head is restored per
    group. It needs the sweep count (vs.shape[0] - 1) to be a multiple of
    ``group_size``.

    With ``shifted`` E is the SHIFTED buffer of ``eigh_large`` (buffer row
    r = E row r + 1, rows (n/b + 2) b: E row 0 is never touched by stage 2,
    since every window starts at row >= 1), which makes every WY window
    exactly two b-row blocks, and the groups are applied by the streaming
    kernels K4 and K5 (:mod:`dlaf_tpu_torch.ops.kernels.bt_apply`). It
    needs f32, ``group_size == b`` and ``bt_apply_feasible(b)``; the record
    may be raw (``raw_bp``) or the port's cooked layout, whose sweep count
    is padded to whole groups with exact no-ops.
    """
    if b == 1:
        return e_mat
    n, nev = e_mat.shape
    if raw_bp is not None:
        nsweeps = vs.shape[0] - 1
        bpt = raw_bp // 128
        if vs.shape[1] % bpt:
            raise ValueError(f"raw record width {vs.shape[1]} not a multiple of {bpt}")
        ncmax = vs.shape[1] // bpt
        g = max(1, min(group_size, nsweeps))
        if nsweeps % g:
            raise ValueError(f"raw record needs nsweeps % group_size == 0 "
                             f"(got {nsweeps} % {g})")
        ngroups = nsweeps // g
    else:
        nsweeps, ncmax, _ = vs.shape
        g = max(1, min(group_size, nsweeps))
        ngroups = -(-nsweeps // g)
        nspad = ngroups * g
        if nspad > nsweeps:   # padded sweeps have tau == 0: exact no-ops
            vs = torch.cat([vs, vs.new_zeros((nspad - nsweeps, ncmax, b))], dim=0)
            taus = torch.cat([taus, taus.new_zeros((nspad - nsweeps, ncmax))], dim=0)
    if shifted:
        if g != b or not bt_apply_feasible(b, e_mat.dtype):
            raise ValueError("the shifted apply needs f32, group_size == band and "
                             f"bt_apply_feasible(band) (got g={g}, b={b}, {e_mat.dtype})")
        return _shifted_apply(e_mat, vs, taus, b, g, ngroups, ncmax, sweep_lo, raw_bp)
    win = b + g - 1
    if prepadded:
        ep, n = e_mat, n - win
    else:
        ep = torch.cat([e_mat, e_mat.new_zeros((win, nev))], dim=0)
    for k in range(ngroups):
        s0 = (ngroups - 1 - k) * g
        # chases c >= ceil((n - 1 - s)/b) lie past the band end for every
        # sweep s >= s0 of the group (tau == 0): every chase that remains
        # has r0 + win <= n - 1 + win, inside the workspace
        ncv = min(ncmax, max(0, -(-(n - 1 - (sweep_lo + s0)) // b)))
        if ncv == 0:
            continue
        v, t = wy_group_vt(*_group_reflectors(vs, taus, s0, g, b, ncv, raw_bp))
        th = ct(t)
        for c in range(ncv):
            r0 = sweep_lo + s0 + 1 + c * b
            blk = ep[r0:r0 + win]
            # E <- Q^H E = E - V T^H (V^H E)
            blk -= mm(v[c], mm(th[c], mm(ct(v[c]), blk)))
    return ep if prepadded else ep[:n]


def bt_reduction_to_band(e_mat, a_packed, taus, band: int, panel_group: int = 4):
    """E <- Q_stage1 E using the panels stored in the packed stage-1 output.

    e_mat: (n, nev); a_packed/taus: outputs of ``reduction_to_band``.
    Panels apply in reverse order, ``panel_group`` consecutive panels as one
    wide compact-WY block; the ragged tail group first, with its true
    width. V is zero above each group's first head row j0 + b, so the
    update touches rows [j0 + b, n) of E only. Returns a new tensor.
    """
    n, nev = e_mat.shape
    b = band
    npanels = max(n // b - 1, 0)
    if npanels == 0:
        return e_mat
    pg = max(1, min(panel_group, npanels))
    pgb = pg * b
    ngroups = -(-npanels // pg)
    e = e_mat.clone()

    def apply_group(j0: int, wcols: int):
        h0 = j0 + b                       # head row of the group's first column
        v = torch.tril(a_packed[h0:, j0:j0 + wcols], -1)
        v.diagonal().fill_(1)
        t = t_factor(v, taus[j0:j0 + wcols])
        sub = e[h0:]
        sub -= mm(v, mm(t, mm(ct(v), sub)))

    wt = npanels - (ngroups - 1) * pg
    apply_group((ngroups - 1) * pgb, wt * b)
    for k in range(ngroups - 1):
        apply_group((ngroups - 2 - k) * pgb, pgb)
    return e
