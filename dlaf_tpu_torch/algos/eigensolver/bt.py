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

The streaming apply of the JAX package (``shifted``, ``raw_bp``: its Pallas
kernels K4/K5 and the raw record of ``eigh_large``) is not ported yet.
"""
from __future__ import annotations

import torch

from ...ops.core import ct, mm
from ...ops.householder import t_factor
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
    buffer back. Returns a new tensor unless ``prepadded``, which updates
    the given buffer in place.
    """
    if raw_bp is not None or shifted:
        raise NotImplementedError(
            "the raw-record and shifted streaming apply (kernels K4/K5, eigh_large) "
            "come with slice 3 of the port (ROADMAP Queue 1 item 6)")
    if b == 1:
        return e_mat
    n, nev = e_mat.shape
    nsweeps, ncmax, _ = vs.shape
    g = max(1, min(group_size, nsweeps))
    ngroups = -(-nsweeps // g)
    nspad = ngroups * g
    if nspad > nsweeps:   # padded sweeps have tau == 0: exact no-ops
        vs = torch.cat([vs, vs.new_zeros((nspad - nsweeps, ncmax, b))], dim=0)
        taus = torch.cat([taus, taus.new_zeros((nspad - nsweeps, ncmax))], dim=0)
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
        v, t = wy_group_vt(vs[s0:s0 + g, :ncv].transpose(0, 1),
                           taus[s0:s0 + g, :ncv].transpose(0, 1))
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
