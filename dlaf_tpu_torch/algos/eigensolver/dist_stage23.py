"""Distributed stages 2 and 3 glue and the two back-transformations.

PyTorch counterpart of :mod:`dlaf_tpu.algos.eigensolver.dist_stage23`
(reference ``band_to_tridiag/mc.h:990``, ``bt_band_to_tridiag/impl.h:177-535``,
``bt_reduction_to_band/impl.h:239``). Data between the stages, on every
rank of the grid:

  - packed stage-1 output: a block-cyclic DistMatrix;
  - the band: replicated strip storage, O(n*b) (the reference's 1-D band
    re-distribution, ``get_1d_block_size.h:19-21``);
  - the stage-2 reflector record: sweep-sharded, the rank at flat index k
    (p*Q + q) holding sweeps [k*chunk, (k+1)*chunk), O(n^2/D);
  - the eigenvector matrix: column-sharded, the rank at flat index k
    holding columns [k*cc, (k+1)*cc). Every reflector acts on rows, so
    both back-transformations run on the local columns; only reflector
    groups, O(n*b), are summed over the grid.

Stage 2 chases the replicated band on every rank, through kernel K3 on a
CUDA tensor of f32 or complex64 (each rank recording its own sweep chunk),
or pipelines the sweeps across the ranks (``band_to_tridiag_dist_mode``
"pipelined"). JAX runs each of these as one ``shard_map`` program; here
each rank runs eager loops and posts the same collectives in the same
order.
"""
from __future__ import annotations

import torch

from ...comm import collectives as coll
from ...dist import local_shard
from ...matrix.dist_matrix import DistMatrix, global_indices
from ...ops.core import ct, mm
from ...ops.householder import t_factor
from ...ops.kernels.band2tridiag import band_to_tridiag_strips_kernel, chaser_feasible
from ...tune import get_tune_parameters
from .band_strips import (COL_BASE, STRIP_W, band_to_tridiag_strips, chase_wavefront_step,
                          n_strips, restripe, wavefront_chases, wavefront_k, wavefront_nsteps)
from .bt import wy_group_vt
from .dist_red2band import replicated_panel
from .driver import pad_diagonal
from .tridiag_dc_dist import all_to_all_flat, flat_index, rank_of_flat

# ---------------------------------------------------------------------------
# padding fix-up


def _pad_fix(data: torch.Tensor, *, nb: int, n: int, pm: int, grid) -> torch.Tensor:
    """This rank's shard with the padding region zeroed and the decoupled
    padding diagonal (:func:`.driver.pad_diagonal`, max|A| over the grid)
    on its entries of the diagonal. A new tensor; ``data`` itself where
    nothing is padded."""
    if n >= pm:
        return data
    P, Q = grid.grid_size
    p, q = grid.coords
    lm, ln = data.shape
    grow = global_indices(lm // nb, nb, P, p, data.device)
    gcol = global_indices(ln // nb, nb, Q, q, data.device)
    nr = int((grow < n).sum())
    nc = int((gcol < n).sum())
    amax = data[:nr, :nc].abs().amax().reshape(1) if nr and nc else data.new_zeros((1,)).abs()
    amax = coll.allreduce_max(amax, None, grid)[0]
    out = data.clone()
    out[nr:] = 0
    out[:, nc:] = 0
    # the padding diagonal entries this rank holds
    tile = grow // nb
    lcol = (tile // Q) * nb + grow % nb
    rows = torch.nonzero((grow >= n) & (tile % Q == q) & (lcol < ln)).squeeze(1)
    out[rows, lcol[rows]] = pad_diagonal(amax, n, grow[rows] - n).to(out.dtype)
    return out


# ---------------------------------------------------------------------------
# band extraction: packed DistMatrix -> replicated strip storage


def strips_from_packed_dist(packed: DistMatrix, band: int | None = None) -> torch.Tensor:
    """Replicated strip storage of the band held in a packed stage-1
    DistMatrix (band | block size): each rank places the band entries of
    its diagonal and subdiagonal tiles, then one allreduce (of the band's
    columns only), then :func:`.band_strips.restripe` where band < nb.
    Reflectors strictly below the band are masked away. Holds
    n_strips(pm, band) + 3 strips (K3's dead strips included)."""
    nb = packed.block_size
    band = band or nb
    grid = packed.grid
    P, Q = grid.grid_size
    p, q = grid.coords
    a = packed.data
    pm = packed.dist.padded_size[0]
    nrt = pm // nb
    rl = torch.arange(nb, device=a.device)[:, None]
    cl = torch.arange(nb, device=a.device)[None, :]
    diag_m = (rl >= cl) & (rl - cl <= band)
    sub_m = (cl >= rl) & (nb + rl - cl <= band)
    # the band's columns of a strip: [3nb - band, 4nb) (subdiagonal tile's
    # last band columns, then the diagonal tile)
    slab = a.new_zeros((nrt, nb, nb + band))
    for s in range(nrt):
        if s % P != p:
            continue
        r = (s // P) * nb
        if s % Q == q:
            c = (s // Q) * nb
            slab[s, :, band:] = torch.where(diag_m, a[r:r + nb, c:c + nb], 0)
        if s > 0 and (s - 1) % Q == q:
            c = ((s - 1) // Q) * nb
            slab[s, :, :band] = torch.where(sub_m, a[r:r + nb, c:c + nb], 0)[:, nb - band:]
    slab = coll.allreduce_sum(slab, None, grid)
    out = a.new_zeros((n_strips(pm, nb) + 3, nb, STRIP_W * nb))
    out[:nrt, :, 3 * nb - band:4 * nb] = slab
    if band != nb:
        out = restripe(out, nb, band, n_strips(pm, band) + 3)
    return out


# ---------------------------------------------------------------------------
# stage 2: replicated chasing, sweep-sharded reflector record


def band_to_tridiag_dist(strips: torch.Tensor, n_eff: int, b: int, grid):
    """Stage 2 on replicated strips (every rank calls it). Every rank
    chases the O(n*b) band the same way and records only its own sweep
    chunk of the O(n^2) reflector set: kernel K3 where it takes (b, dtype)
    (on a CUDA tensor: f32 or complex64, 8 <= b <= 384; its plain version
    on a CPU tensor), the plain strip chase otherwise.

    Returns (d, e, vs, taus), vs/taus this rank's chunk of the record
    (chunk, ncmax, b) / (chunk, ncmax), chunk = ceil(nsweeps / D): the rank
    at flat index k holds sweeps [k*chunk, (k+1)*chunk); sweeps past the
    last (the last rank's tail) have tau = 0. With
    ``band_to_tridiag_dist_mode`` "pipelined", the compute-distributed
    chase (:func:`band_to_tridiag_dist_pipelined`).
    """
    if get_tune_parameters().band_to_tridiag_dist_mode == "pipelined":
        return band_to_tridiag_dist_pipelined(strips, n_eff, b, grid)
    nsweeps = max(n_eff - 2, 1)
    chunk = -(-nsweeps // grid.size)
    lo = flat_index(grid) * chunk
    if n_eff >= 3 and chaser_feasible(b, strips.dtype):
        return band_to_tridiag_strips_kernel(strips, n_eff, b, sweep_lo=lo, sweep_chunk=chunk)
    return band_to_tridiag_strips(strips, n_eff, b, sweep_lo=lo, sweep_chunk=chunk)


# ---------------------------------------------------------------------------
# stage 2 (pipelined): compute-distributed chase over band-column segments
#
# The rank at flat index k owns strips [k*S, (k+1)*S); each wavefront step
# t runs the t = 3s + c chases whose rows start in that segment
# (band_strips.chase_wavefront_step); the two strips past a segment's end
# come from the next rank before a step that reaches them and go back after
# it (reference SweepWorkerDist handoff, band_to_tridiag/mc.h:568-661). The
# result is bit-identical to the sequential chase.


def _halo_step(t: int, seg: int, *, n: int, b: int, S: int, K: int) -> bool:
    """Whether a chase of segment ``seg`` at wavefront step ``t`` reaches
    the two strips past the segment's end (each chase reads and writes the
    three strips from its first row's). Where none does, the segment does
    not read its halo and returns it unchanged: both exchanges of the step
    with the next rank are left out, which leaves every strip as the
    exchange would (JAX exchanges at every step)."""
    return any((i0 - seg * S * b) // b + 2 >= S
               for _, _, i0 in wavefront_chases(t, n=n, b=b, S=S, seg0=seg * S, K=K))


def _stage2_pipelined(strips, *, n_eff: int, b: int, S: int, K: int, T: int, nrec: int, grid):
    """This rank's segment chase: (d, e) replicated and the
    segment-local record vs (nrec + 1, S + 1, b), taus (nrec + 1, S + 1).
    The next rank's first two strips come in before a step whose chases
    reach them, and go back after it (JAX's ppermute from the next rank and
    to it)."""
    did = flat_index(grid)
    D = grid.size
    seg0 = did * S
    loc = strips[seg0:seg0 + S].clone()
    vs = strips.new_zeros((nrec + 1, S + 1, b))
    taus = strips.new_zeros((nrec + 1, S + 1))
    left = rank_of_flat(grid, did - 1) if did > 0 else None
    right = rank_of_flat(grid, did + 1) if did < D - 1 else None
    for t in range(T):
        mine = right is not None and _halo_step(t, did, n=n_eff, b=b, S=S, K=K)
        lefts = left is not None and _halo_step(t, did - 1, n=n_eff, b=b, S=S, K=K)
        pre = loc[:2].clone()
        if mine or lefts:
            halo = coll.sendrecv(pre, left if lefts else None, right if mine else None,
                                 pre.shape)
        else:
            halo = torch.zeros_like(pre)
        ext = torch.cat([loc, halo], dim=0)
        chase_wavefront_step(ext, vs, taus, t, n=n_eff, b=b, S=S, seg0=seg0, K=K)
        loc = ext[:S]
        if mine or lefts:
            # merge-back is an exact overwrite, not an additive delta (a
            # delta merge injects eps noise at every hand-over): the cells
            # the left neighbour changed are those whose returned value
            # differs from what was sent (concurrent windows are
            # element-disjoint)
            back = coll.sendrecv(ext[S:], right if mine else None, left if lefts else None,
                                 pre.shape)
            if lefts:
                loc[:2] = torch.where(back != pre, back, loc[:2])
    i = torch.arange(b, device=strips.device)
    de = torch.zeros((2, D * S * b), dtype=strips.dtype, device=strips.device)
    de[0, seg0 * b:(seg0 + S) * b] = loc[:, i, i + COL_BASE * b].reshape(S * b)
    de[1, seg0 * b:(seg0 + S) * b] = loc[:, i, i + COL_BASE * b - 1].reshape(S * b)
    de = coll.allreduce_sum(de, None, grid)
    d = de[0, :n_eff]
    return (d.real if d.is_complex() else d), de[1, 1:n_eff], vs, taus


def _record_reshard(vs, taus, *, nsweeps: int, chunk: int, S: int, b: int, ncmax: int, grid):
    """Segment-local record (all sweeps, the segment's chases) ->
    sweep-sharded record (this rank's chunk of sweeps, all chases): one
    all-to-all over sweep chunks, then each segment's window placed at its
    chase offset c_lo(s) = max(0, seg*S - (s+1)//b)."""
    D = grid.size
    cseg = S + 1
    ncmax_pad = (D - 1) * S + cseg
    dev = vs.device
    x = torch.cat([vs[:D * chunk], taus[:D * chunk, :, None]], dim=2)   # (D chunk, cseg, b+1)
    got = all_to_all_flat(x.reshape(D, chunk, cseg, b + 1), grid)
    s = flat_index(grid) * chunk + torch.arange(chunk, device=dev)
    got = torch.where((s < nsweeps)[None, :, None, None], got, 0)
    out = vs.new_zeros((chunk, ncmax_pad, b + 1))
    rows = torch.arange(chunk, device=dev)[:, None].expand(chunk, cseg)
    for src in range(D):
        c_off = torch.clamp(src * S - (s + 1) // b, min=0, max=ncmax_pad - cseg)
        cols = c_off[:, None] + torch.arange(cseg, device=dev)[None, :]
        out.index_put_((rows, cols), got[src], accumulate=True)
    out = out[:, :ncmax]
    return out[..., :b].contiguous(), out[..., b].contiguous()


def band_to_tridiag_dist_pipelined(strips: torch.Tensor, n_eff: int, b: int, grid):
    """Compute-distributed stage 2 (see the comment above), every rank of
    the grid calling it. Same output contract as
    :func:`band_to_tridiag_dist`: (d, e) replicated, this rank's
    sweep chunk of the record."""
    D = grid.size
    ns = strips.shape[0]
    S = -(-ns // D)
    if D * S > ns:
        strips = torch.cat([strips, strips.new_zeros((D * S - ns, *strips.shape[1:]))])
    nsweeps = max(n_eff - 2, 1)
    chunk = -(-nsweeps // D)
    d, e, vs, taus = _stage2_pipelined(strips, n_eff=n_eff, b=b, S=S, K=wavefront_k(S, b),
                                       T=wavefront_nsteps(n_eff, b), nrec=D * chunk, grid=grid)
    vs, taus = _record_reshard(vs, taus, nsweeps=nsweeps, chunk=chunk, S=S, b=b,
                               ncmax=-(-(n_eff - 1) // b), grid=grid)
    return d, e, vs, taus


# ---------------------------------------------------------------------------
# back-transformation: bulge-chase reflectors on column-sharded eigenvectors


def bt_band_to_tridiag_dist(qc: torch.Tensor, vs: torch.Tensor, taus: torch.Tensor, b: int,
                            n_eff: int, grid, group_size: int = 64) -> torch.Tensor:
    """E <- Q_stage2 E on this rank's columns ``qc`` (m, w) with the
    sweep-sharded record (every rank calls it); a new tensor.

    Groups of ``group_size`` sweeps (reduced to a divisor of the padded
    sweep count) are assembled by one allreduce each, every rank giving
    the sweeps it owns (a group may span owners), and applied locally as
    staggered compact-WY blocks, two GEMMs and a small one a chase, in
    reverse sweep order. Chases past the band end of every sweep of a
    group carry no reflector and are skipped.
    """
    D = grid.size
    did = flat_index(grid)
    chunk, ncmax, _ = vs.shape
    nsweeps_pad = chunk * D
    gsz = min(group_size, nsweeps_pad)
    while nsweeps_pad % gsz:
        gsz -= 1
    m, ncols = qc.shape
    win = b + gsz - 1
    pad_rows = max(nsweeps_pad + ncmax * b + gsz - m, 0)
    ep = torch.cat([qc, qc.new_zeros((pad_rows, ncols))], dim=0)
    rec = torch.cat([vs, taus[:, :, None]], dim=2)               # (chunk, ncmax, b+1)
    ngroups = nsweeps_pad // gsz
    for k in range(ngroups):
        s0 = (ngroups - 1 - k) * gsz
        ncv = min(ncmax, max(0, -(-(n_eff - 1 - s0) // b)))
        if ncv == 0:
            continue
        lo, hi = max(s0, did * chunk), min(s0 + gsz, (did + 1) * chunk)
        grp = rec.new_zeros((gsz, ncv, b + 1))
        if lo < hi:
            grp[lo - s0:hi - s0] = rec[lo - did * chunk:hi - did * chunk, :ncv]
        grp = coll.allreduce_sum(grp, None, grid).transpose(0, 1)   # chase-major
        v, t = wy_group_vt(grp[..., :b], grp[..., b])
        th = ct(t)
        for c in range(ncv):
            r0 = s0 + 1 + c * b
            blk = ep[r0:r0 + win]
            # E <- Q^H E = E - V T^H (V^H E)
            blk -= mm(v[c], mm(th[c], mm(ct(v[c]), blk)))
    return ep[:m]


# ---------------------------------------------------------------------------
# back-transformation: stage-1 panels on column-sharded eigenvectors


def bt_reduction_to_band_dist(qc: torch.Tensor, packed: DistMatrix, taus: torch.Tensor,
                              band: int | None = None) -> torch.Tensor:
    """E <- Q_stage1 E on this rank's columns ``qc`` (every rank calls it);
    a new tensor. Each panel, last to first, is gathered from the packed
    DistMatrix as stage 1 gathered it (rows at or past its head only) and
    applied as one compact-WY block, E -= V (T (V^H E))."""
    nb = packed.block_size
    band = band or nb
    pm = packed.dist.padded_size[0]
    npanels = max(pm // band - 1, 0)
    e = qc.clone()
    for kk in range(npanels - 1, -1, -1):
        j0 = kk * band
        r0 = j0 + band
        v = torch.tril(replicated_panel(packed.data, j0, r0, band, nb, packed.grid), -1)
        v.diagonal().fill_(1)
        t = t_factor(v, taus[j0:r0])
        etop = e[r0:pm]
        etop -= mm(v, mm(t, mm(ct(v), etop)))
    return e


# ---------------------------------------------------------------------------
# final layout change: column shards -> canonical block-cyclic


def _c2c_slots(qc: torch.Tensor, *, nb: int, pm: int, lmt: int, lnt: int, grid) -> torch.Tensor:
    """Column shard (m, w) -> this rank's canonical (lm, ln) shard by one
    uniform tile-slot all-to-all (reference
    ``permutations/general/impl.h:230-303``). My column tile j (global
    T = k*w/nb + j, k my flat index) goes to grid column T % Q; to each
    rank I send its grid row's rows of the tiles for its grid column, in
    wq = ceil(wt/Q) slots."""
    P, Q = grid.grid_size
    D = grid.size
    did = flat_index(grid)
    w = qc.shape[1]
    wt = w // nb
    wq = -(-wt // Q)
    lm = lmt * nb
    rows = qc[:pm].reshape(lmt, P, nb, wt, nb)        # (local row tile, p_t, r, col tile, c)
    send = qc.new_zeros((D, lm, wq * nb))
    for k_t in range(D):
        p_t, q_t = divmod(k_t, Q)
        for i in range(wq):
            j = (q_t - did * wt) % Q + i * Q
            if j < wt:
                send[k_t, :, i * nb:(i + 1) * nb] = rows[:, p_t, :, j].reshape(lm, nb)
    rcv = all_to_all_flat(send, grid)                  # (D src, lm, wq nb)
    q = grid.coords[1]
    out = qc.new_empty((lm, lnt * nb))
    for c in range(lnt):
        g = c * Q + q                                  # global column tile
        src, j = divmod(g, wt)
        i = (j - (q - src * wt) % Q) // Q
        out[:, c * nb:(c + 1) * nb] = rcv[src, :, i * nb:(i + 1) * nb]
    return out


def cols_to_canonical(qc: torch.Tensor, *, dist, grid) -> torch.Tensor:
    """This rank's column shard of the (m, D*w) eigenvector matrix ->
    its canonical block-cyclic shard of ``dist`` (every rank calls it).
    Tile-aligned shards (w a multiple of the block size) take one
    tile-slot all-to-all; others are gathered whole and cut (JAX: a GSPMD
    resharding)."""
    nb = dist.block_size[0]
    pm, pn = dist.padded_size
    if grid.size == 1:
        return qc[:pm, :pn].contiguous()
    if qc.shape[1] % nb == 0:
        lmt, lnt = dist.max_local_nr_tiles
        return _c2c_slots(qc, nb=nb, pm=pm, lmt=lmt, lnt=lnt, grid=grid)
    full = gather_columns(qc, grid)
    return local_shard(full[:pm, :pn].contiguous(), dist, grid.coords)


def column_shard(x: torch.Tensor, grid, width: int | None = None) -> torch.Tensor:
    """This rank's columns of the replicated matrix ``x`` in the layout
    the back-transformations take: the rank at flat index k holds columns
    [k*width, (k+1)*width), width = ceil(ncols / D) by default, zero
    columns past the last (JAX: ``device_put`` with ``P(None, AXES)``)."""
    D = grid.size
    width = width or -(-x.shape[1] // D)
    k = flat_index(grid)
    out = x.new_zeros((x.shape[0], width))
    part = x[:, k * width:(k + 1) * width]
    out[:, :part.shape[1]] = part
    return out


def gather_columns(qc: torch.Tensor, grid) -> torch.Tensor:
    """The whole column-sharded matrix, on every rank (every rank calls
    it): the shards side by side in flat order."""
    if grid.size == 1:
        return qc
    shards = coll.allgather_tiles(qc, None, grid)    # rank order
    return torch.cat([shards[rank_of_flat(grid, k)] for k in range(grid.size)], dim=1)
