"""Distributed tridiagonal divide & conquer.

PyTorch counterpart of :mod:`dlaf_tpu.algos.eigensolver.tridiag_dc_dist`
(reference ``eigensolver/tridiag_solver/merge.h:1810-1941``
``mergeDistSubproblems``): the eigenvector matrix, the O(n^2) object of
stage 3, is partitioned over the ranks of the grid (flattened in row-major
order, rank (p, q) at index p*Q + q) at every level of the merge tree:

 - deep levels (a rank holds whole merges): the merges are local, the
   batched ``_merge``/``_merge_vectors`` of :mod:`.tridiag_dc` on the
   rank's own batches;
 - top levels (fewer merges than ranks): each merge's eigenvector block is
   row-sharded over its group of ranks. The block-diagonal embedding
   [[Q1, 0], [0, Q2]] is local under that layout, so eigenvector data
   never moves; only O(n) vectors are summed over the grid (z, the
   secular roots, zhat, the eigenvalues), one allreduce each, and each
   rank of a group solves its chunk of the secular equation;
 - the deflation rotations, the sorted-d permutation and the eigenvalue
   sort are folded into the chunked rank-one factor, so the big product
   runs permutation-free;
 - the final exchange from row shards to column shards is one tile-slot
   all-to-all (``coll.all_to_all_slots``).

JAX runs all of it as one ``shard_map`` program; here every rank runs the
levels eagerly and posts the same collectives in the same order. A rank
count that is not a power of two runs the merge tree on the largest
power-of-two subset D2 <= D; the other ranks skip the work and post every
collective with zeros (the reference supports such grids directly), and
the final all-to-all gives column shards to all D ranks.
"""
from __future__ import annotations

import torch

from ...comm import collectives as coll
from ...comm.mesh import Grid
from .tridiag_dc import LEAF, _deflate as _deflate_scan, _jacobi_eigh, _merge, _merge_vectors


def pow2_floor(ndev: int) -> int:
    """Largest power of two <= ndev (the active merge-tree subset size)."""
    return 1 << (max(ndev, 1).bit_length() - 1)


def merge_tree_idle_fraction(ndev: int) -> float:
    """Fraction of ranks idle during the stage-3 merge tree, which runs on
    the largest power-of-two subset of the ranks: 1/3 on 6 ranks, none on
    a power of two. Stages 1, 2, 4 and 5 and the final all-to-all use all
    ranks."""
    return (ndev - pow2_floor(ndev)) / ndev


def dc_dist_supported(n: int, ndev: int) -> bool:
    m = LEAF
    while m < n:
        m *= 2
    d2 = pow2_floor(ndev)
    return m % d2 == 0 and m // d2 >= 1


def flat_index(grid: Grid, rank: int | None = None) -> int:
    """The index of ``rank`` (default: this rank) in the row-major
    flattening of the grid (JAX's flat device order over (ROW_AXIS,
    COL_AXIS))."""
    p, q = grid.coords if rank is None else grid.coords_of(rank)
    return p * grid.grid_size[1] + q


def rank_of_flat(grid: Grid, did: int) -> int:
    """The global rank at flat index ``did``."""
    return grid.rank_of(did // grid.grid_size[1], did % grid.grid_size[1])


def all_to_all_flat(x: torch.Tensor, grid: Grid) -> torch.Tensor:
    """All-to-all over the flattened grid: ``x[d]`` goes to the rank at
    flat index d; returns (D, ...) whose slot d came from the rank at flat
    index d (JAX ``lax.all_to_all`` over both axes, tiled). The identity
    on a 1x1 grid."""
    order = torch.tensor([flat_index(grid, r) for r in range(grid.size)], device=x.device)
    got = coll.all_to_all_slots(x.index_select(0, order), grid)
    return torch.empty_like(got).index_copy_(0, order, got)


# ---------------------------------------------------------------------------
# deflation (replicated, per merge)


def _deflate(d, z, rho, tol_scale):
    """Sorted-d deflation analysis of one merge (d, z (n,), rho >= 0).

    Returns (ds, zmask, zs2, perm, deflated, rots, tol); ``rots`` holds
    (c, s, prev or -1, i), each (n,), the rotations of the scan of
    :func:`.tridiag_dc._deflate`.
    """
    eps = torch.finfo(d.dtype).eps
    perm = torch.argsort(d, stable=True)
    ds = d[perm]
    zs = z[perm]
    dspread = torch.clamp(ds[-1] - ds[0], min=eps)
    tol = 8.0 * eps * torch.maximum(tol_scale, dspread)
    zsmall = (rho * zs).abs() <= tol
    zs2, rots = _deflate_scan(ds[None], zs[None], zsmall[None], tol[None])
    zs2 = zs2[0]
    rots = tuple(r[0] for r in rots)
    deflated = ((rho * zs2).abs() <= tol) | (zs2 == 0)
    zmask = torch.where(deflated, 0.0, zs2)
    return ds, zmask, zs2, perm, deflated, rots, tol


# ---------------------------------------------------------------------------
# chunked secular solve (laed4) over a root range


def _secular_chunk(ds, zmask, rho, deflated, tol, lo: int, csz: int, laed4_iter: int):
    """Solve the secular equation for roots [lo, lo + csz) of one merge.

    All inputs replicated; returns chunk-local (anchor, sgn, troot), the
    root lam_i = ds[anchor_i] + sgn_i * troot_i anchored at its nearer
    pole (the anchored laed4 of :func:`.tridiag_dc._merge`, restricted to
    a chunk; reference ``merge.h:798-974``). The iterations stop once
    every bracket of the chunk is resolved or after ``laed4_iter``.
    """
    n = ds.shape[0]
    dt = ds.dtype
    dev = ds.device
    fi = torch.finfo(dt)
    eps = fi.eps
    z2r = zmask * zmask
    normz2 = z2r.sum()
    tiny = fi.tiny * 1e4

    idx = torch.arange(n, device=dev)
    masked_idx = torch.where(deflated, n, idx)
    sufmin = torch.flip(torch.cummin(torch.flip(masked_idx, [0]), dim=0).values, [0])
    next_idx = torch.cat([sufmin[1:], torch.full((1,), n, dtype=idx.dtype, device=dev)])
    has_next_all = next_idx < n
    next_all = next_idx.clamp(max=n - 1)
    top_delta = rho * normz2 * (1 + 4 * eps) + tol
    delta_all = torch.where(has_next_all, ds[next_all] - ds, top_delta)
    delta_all = torch.clamp(delta_all, min=fi.tiny)

    sl = slice(lo, lo + csz)
    cidx = idx[sl]
    ds_c, defl_c = ds[sl], deflated[sl]
    delta, has_next, next_c = delta_all[sl], has_next_all[sl], next_all[sl]
    dd_c = ds[None, :] - ds_c[:, None]                    # (csz, n)

    def guard(den):
        return torch.where(den.abs() < tiny, torch.where(den < 0, -tiny, tiny), den)

    fmid = 1.0 + rho * (z2r[None, :] / guard(dd_c - (0.5 * delta)[:, None])).sum(1)
    right = (fmid < 0) & has_next
    anchor = torch.where(right, next_c, cidx)
    sgn = torch.where(right, -1.0, 1.0).to(dt)
    dd_a = ds[None, :] - ds[anchor][:, None]
    w_own = z2r[anchor]
    own = anchor[:, None] == idx[None, :]
    tmax = torch.where(right, 0.5 * delta, torch.where(has_next, 0.5 * delta, delta))

    def g_parts(t):
        safe = guard(dd_a - (sgn * t)[:, None])
        terms = z2r[None, :] / safe
        f = 1.0 + rho * terms.sum(1)
        df = rho * (z2r[None, :] / (safe * safe)).sum(1)
        s_no_own = 1.0 + rho * torch.where(own, 0.0, terms).sum(1)
        return sgn * f, df, s_no_own

    lo_ = torch.zeros_like(ds_c)
    hi_ = tmax
    t = 0.5 * tmax
    for _ in range(laed4_iter):
        if not bool(((hi_ - lo_) > 2 * eps * t.abs() + fi.tiny).any()):
            break
        g, df, s_no_own = g_parts(t)
        lo_ = torch.where(g < 0, t, lo_)
        hi_ = torch.where(g < 0, hi_, t)
        newton = t - g / torch.clamp(df, min=fi.tiny)
        fp_den = torch.where(right, -s_no_own, s_no_own)
        fp = rho * w_own / torch.where(fp_den > 0, fp_den, torch.inf)
        t = torch.where((fp > lo_) & (fp < hi_), fp, 0.5 * (lo_ + hi_))
        t = torch.where((newton > lo_) & (newton < hi_), newton, t)
    troot = torch.where(defl_c, 0.0, t)
    anchor = torch.where(defl_c, cidx, anchor)
    sgn = torch.where(defl_c, 1.0, sgn)
    return anchor, sgn, troot


def _zhat_chunk(ds, zs2, anchor, sgn, troot, deflated, lo: int, csz: int):
    """Gu/Eisenstat zhat for rows [lo, lo + csz) of one merge (replicated
    inputs, ``anchor``/``sgn``/``troot`` for every root)."""
    n = ds.shape[0]
    dev = ds.device
    sl = slice(lo, lo + csz)
    ds_c, defl_c, zs2_c = ds[sl], deflated[sl], zs2[sl]
    idx = torch.arange(n, device=dev)
    cidx = idx[sl]
    lam_anchor = ds[anchor]
    mu_all = torch.where((anchor != idx) & ~deflated, lam_anchor + sgn * troot - ds, troot)
    num = (lam_anchor[None, :] - ds_c[:, None]) + (sgn * troot)[None, :]
    dd = ds[None, :] - ds_c[:, None]
    offdiag = cidx[:, None] != idx[None, :]
    safe_den = torch.where(offdiag & (dd != 0), dd, 1.0)
    ratio = torch.where(offdiag, num / safe_den, 1.0)
    ratio = torch.where(offdiag & (dd == 0), 1.0, ratio)
    prod = torch.prod(ratio, dim=1)
    zhat2 = torch.clamp(mu_all[sl] * prod, min=0.0)
    zhat = torch.sign(zs2_c) * torch.sqrt(zhat2)
    return torch.where(defl_c, 0.0, zhat)


# ---------------------------------------------------------------------------
# the distributed solver


def _row_sharded_merge(q_loc, lam_all, e, tol_scale, *, grid: Grid, did: int, act: bool,
                       size: int, nb_new: int, D2: int, rows_loc: int, laed4_iter: int):
    """One top level of the tree: nb_new merges, each over a group of
    g_new = D2 / nb_new ranks holding row shards (``q_loc``, transposed:
    (size, rows_loc)). Returns the new (q_loc (2 size, rows_loc), lam_all
    (nb_new, 2 size)). Every rank posts the four allreduces; an inactive
    rank (``act`` False) only with zeros."""
    dtv = lam_all.dtype
    dev = lam_all.device
    g_new = D2 // nb_new
    g_old = max(g_new // 2, 1)
    ob = did // g_old                                   # old batch
    half, gi_old, j = ob % 2, did % g_old, ob // 2      # new batch j
    gi_new = did % g_new                                # position in its group
    csz = (2 * size) // g_new
    lo = gi_new * csz

    # z assembly: the last row of the left block and the first of the right
    bnd = torch.arange(nb_new, device=dev) * (2 * size) + size
    ecut = e[bnd - 1]
    rho_all = ecut.abs()
    theta = torch.where(ecut >= 0, 1.0, -1.0).to(dtv)
    zbuf = lam_all.new_zeros((nb_new, 2 * size))
    if act and half == 0 and gi_old == g_old - 1:
        zbuf[j, :size] = theta[j] * q_loc[:, -1]
    if act and half == 1 and gi_old == 0:
        zbuf[j, size:] = q_loc[:, 0]
    z_all = coll.allreduce_sum(zbuf, None, grid)

    # my merge's deflation (replicated over its group) and secular chunk
    rbuf = lam_all.new_zeros((nb_new, 3, 2 * size))
    if act:
        rho = rho_all[j]
        ds, zmask, zs2, perm, defl, rots, tolj = _deflate(
            lam_all.reshape(nb_new, 2 * size)[j], z_all[j], rho, tol_scale)
        anch_c, sgn_c, troot_c = _secular_chunk(ds, zmask, rho, defl, tolj, lo, csz, laed4_iter)
        rbuf[j, :, lo:lo + csz] = torch.stack([anch_c.to(dtv), sgn_c, troot_c])
    rall = coll.allreduce_sum(rbuf, None, grid)

    zbuf2 = lam_all.new_zeros((nb_new, 2 * size))
    if act:
        anchor = rall[j, 0].round().long()
        sgn, troot = rall[j, 1], rall[j, 2]
        zbuf2[j, lo:lo + csz] = _zhat_chunk(ds, zs2, anchor, sgn, troot, defl, lo, csz)
    zhat_all = coll.allreduce_sum(zbuf2, None, grid)

    lbuf = lam_all.new_zeros((nb_new, 2 * size))
    if act:
        zhat = zhat_all[j]
        lam_sortedd = ds[anchor] + sgn * troot          # in sorted-d order
        order = torch.argsort(lam_sortedd, stable=True)
        if gi_new == 0:
            lbuf[j] = lam_sortedd[order]
    lam_all = coll.allreduce_sum(lbuf, None, grid)
    if not act:
        return q_loc, lam_all

    # ---- local eigenvector update (no communication) ---------------------
    # embed [[Q1, 0], [0, Q2]]: on row shards, in the transposed storage,
    # the block stacks above or below zeros
    zeros = torch.zeros_like(q_loc)
    q_emb = torch.cat([q_loc, zeros] if half == 0 else [zeros, q_loc], dim=0)
    # deflation rotations on columns of Q (rows of Q^T), at pre-permutation
    # indices, in scan order
    rc, rs, rpi, ri = rots
    valid = torch.nonzero(rpi >= 0).flatten()
    pairs = torch.stack([perm[rpi[valid]], perm[ri[valid]]], 1).tolist()
    for k, (pi_o, i_o) in enumerate(pairs):
        c, s = rc[valid[k]], rs[valid[k]]
        rowp, rowi = q_emb[pi_o].clone(), q_emb[i_o].clone()
        q_emb[pi_o] = c * rowp + s * rowi
        q_emb[i_o] = -s * rowp + c * rowi

    # chunked rank-one factor with the sorted-d permutation (rows) and the
    # eigenvalue sort (columns) folded in:
    #   qv[c, i] = zhat[rank_c] / (ds[rank_c] - lam_new[i])
    rank = torch.argsort(perm)
    anchor_s, sgn_s, troot_s, defl_s = anchor[order], sgn[order], troot[order], defl[order]
    eps = torch.finfo(dtv).eps
    acc = q_loc.new_zeros((2 * size, rows_loc))
    nrm = q_loc.new_zeros((2 * size, 1))
    for k in range(g_new):
        c0 = k * csz
        ridx = rank[c0:c0 + csz]
        den = (ds[ridx][:, None] - ds[anchor_s][None, :]) - (sgn_s * troot_s)[None, :]
        qv = zhat[ridx][:, None] / torch.where(den == 0, eps, den)
        qv = torch.where(defl_s[None, :], (ridx[:, None] == order[None, :]).to(dtv), qv)
        acc += qv.T @ q_emb[c0:c0 + csz]
        nrm += (qv * qv).sum(0)[:, None]
    nrm = torch.sqrt(nrm)
    return acc / torch.where(nrm > 0, nrm, 1.0), lam_all


def _tridiag_dc_dist_padded(d, e, laed4_iter: int, grid: Grid, col_align: int):
    """(lam (m,) replicated, this rank's column shard (m, cc) of Q) for the
    padded tridiagonal (d, e) of order m = LEAF * 2^L."""
    m = d.shape[0]
    dev = d.device
    dtv = d.dtype
    nblocks = m // LEAF
    levels = (nblocks - 1).bit_length()
    D = grid.size
    did = flat_index(grid)
    D2 = pow2_floor(D)
    act = did < D2
    # the column chunk of the final exchange: ceil(m / D) rounded up to
    # col_align (the caller's tile size keeps cols_to_canonical on its
    # tile-slot route)
    cc = m if D == 1 else col_align * (-(-m // (D * col_align)))

    # Cuppen tears at every leaf boundary (replicated diagonal-only mod)
    dmod = d.clone()
    if nblocks > 1:
        bidx = torch.arange(1, nblocks, device=dev) * LEAF
        rho_all = e[bidx - 1].abs()
        dmod[bidx - 1] -= rho_all
        dmod[bidx] -= rho_all
    dleaf = dmod.reshape(nblocks, LEAF)
    eleaf = e.reshape(nblocks, LEAF)[:, :-1]
    tmats = torch.diag_embed(dleaf) + torch.diag_embed(eleaf, 1) + torch.diag_embed(eleaf, -1)
    lam_all, q_leaf = _jacobi_eigh(tmats)              # replicated
    tol_scale = d.abs().max() + 2 * e.abs().max()

    # Eigenvector blocks are carried transposed (see tridiag_dc._merge_vectors).
    # Deep levels hold (nb_loc, size, size) batches; top levels hold
    # q_loc = Q^T[:, row block], (size, rows_loc).
    rows_loc = m // D2
    if nblocks >= D2:
        nb_loc = nblocks // D2
        q_loc = q_leaf[did * nb_loc:(did + 1) * nb_loc].mT.contiguous() if act else None
        lam_loc = lam_all[did * nb_loc:(did + 1) * nb_loc] if act else None
        deep = True
    else:
        g0 = D2 // nblocks
        rows0 = LEAF // g0
        bi, gi = divmod(did, g0)
        q_loc = q_leaf[bi, gi * rows0:(gi + 1) * rows0].T.contiguous() if act else None
        deep = False

    size, nbatch = LEAF, nblocks
    for _ in range(levels):
        nb_new = nbatch // 2
        if nb_new >= D2:
            if act:
                # device-local merges of this rank's batches
                first_g = did * (nbatch // D2) // 2
                q1, q2 = q_loc[0::2], q_loc[1::2]
                nb_loc2 = q1.shape[0]
                bnd = (first_g + torch.arange(nb_loc2, device=dev)) * (2 * size) + size
                ecut = e[bnd - 1]
                theta = torch.where(ecut >= 0, 1.0, -1.0).to(dtv)
                dcat = torch.cat([lam_loc[0::2], lam_loc[1::2]], dim=1)
                zcat = torch.cat([theta[:, None] * q1[:, :, -1], q2[:, :, 0]], dim=1)
                lamv, zhat, ds, perm, root, defl, rots = _merge(dcat, zcat, ecut.abs(), tol_scale,
                                                                 laed4_iter)
                lam_loc, q_loc = _merge_vectors(q1, q2, lamv, zhat, perm, root, defl, rots, ds)
        else:
            if deep:
                # deep -> top (nbatch == D2: one batch a rank): replicate
                # the eigenvalues; the (size, size) batch is the row shard
                buf = d.new_zeros((nbatch, size))
                if act:
                    buf[did] = lam_loc[0]
                    q_loc = q_loc[0]
                lam_all = coll.allreduce_sum(buf, None, grid)
                deep = False
            q_loc, lam_all = _row_sharded_merge(
                q_loc, lam_all, e, tol_scale, grid=grid, did=did, act=act, size=size,
                nb_new=nb_new, D2=D2, rows_loc=rows_loc, laed4_iter=laed4_iter)
        size *= 2
        nbatch = nb_new

    if deep:                    # D2 == 1: every level was local
        return lam_loc.reshape(m), q_loc[0].T
    # row shards (on the D2 active ranks) -> Q's column shards on all D
    # ranks: one all-to-all splitting the column index (axis 0 of the
    # transposed storage, zero-padded to cc*D), then a local transpose;
    # the inactive ranks send zeros, which land past column m
    send = d.new_zeros((cc * D, rows_loc))
    if act:
        send[:m] = q_loc
    got = all_to_all_flat(send.reshape(D, cc, rows_loc), grid)      # (D src, cc, rows_loc)
    q_cols = got.permute(1, 0, 2).reshape(cc, D * rows_loc)[:, :m].T
    return lam_all.reshape(m), q_cols.contiguous()


def tridiag_eigh_dist(d, e, grid: Grid, laed4_iter: int = 120, col_align: int = 1):
    """Distributed eigendecomposition of the symmetric tridiagonal (d, e),
    replicated on every rank of ``grid`` (every rank calls it).

    Returns (lam (m,) replicated, this rank's column shard of q, m), m the
    padded D&C size: q has m rows, and the rank at flat index k (p*Q + q)
    holds its columns [k*cc, (k+1)*cc), cc = ceil(m / D) rounded up to
    ``col_align`` (zero columns past m); q[:n, :n] is the eigenvector
    matrix and the padding block is decoupled. Check
    :func:`dc_dist_supported` first.
    """
    from .tridiag_dc import laed4_iter_cap
    laed4_iter = laed4_iter_cap(d.dtype, laed4_iter)
    n = d.shape[0]
    m = LEAF
    while m < n:
        m *= 2
    emax = e.abs().max() if n > 1 else d.new_zeros(())
    gersh = d.abs().max() + 2 * emax
    padvals = gersh + 1.0 + torch.arange(m - n, dtype=d.dtype, device=d.device)
    dp = torch.cat([d, padvals])
    ep = d.new_zeros((m,))
    if n > 1:
        ep[:n - 1] = e
    lam, q = _tridiag_dc_dist_padded(dp, ep, laed4_iter, grid, col_align)
    return lam, q, m
