"""Distributed tridiagonal divide & conquer.

PyTorch counterpart of :mod:`dlaf_tpu.algos.eigensolver.tridiag_dc_dist`
(reference ``eigensolver/tridiag_solver/merge.h:1810-1941``
``mergeDistSubproblems``): the eigenvector matrix, the O(n^2) object of
stage 3, is partitioned over the ranks of the grid (flattened in row-major
order, rank (p, q) at index p*Q + q) at every level of the merge tree:

 - deep levels (a rank holds whole merges): the merges are local, the
   batched merge level of :mod:`.tridiag_dc` on the rank's own batches;
 - top levels (fewer merges than ranks): each merge's eigenvector block is
   row-sharded over its group of ranks. The block-diagonal embedding
   [[Q1, 0], [0, Q2]] is local under that layout, so eigenvector data
   never moves; only O(n) vectors are summed over the grid (z, the
   secular roots, zhat, the eigenvalues), one allreduce each. Every rank
   of a group runs the local levels' three functions on its merge as a
   batch of one: the deflation analysis (replicated over the group), then
   the laed4 root solve for its chunk of the roots, then, after the
   roots' allreduce, zhat for the same chunk of rows;
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
from .tridiag_dc import (LEAF, _dc_order, _dc_pad, _deflation, _leaves, _merge_level,
                         _secular_roots, _zhat, laed4_iter_cap)


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
    m = _dc_order(n)
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

    # my merge's deflation (replicated over its group) and its chunk of
    # the roots, a batch of one merge
    rbuf = lam_all.new_zeros((nb_new, 3, 2 * size))
    if act:
        rho = rho_all[j:j + 1]
        dfl = _deflation(lam_all.reshape(nb_new, 2 * size)[j:j + 1], z_all[j:j + 1], rho,
                         tol_scale)
        anch_c, sgn_c, troot_c = _secular_roots(dfl, rho, laed4_iter, lo, csz)
        rbuf[j, :, lo:lo + csz] = torch.cat([anch_c.to(dtv), sgn_c, troot_c])
    rall = coll.allreduce_sum(rbuf, None, grid)

    zbuf2 = lam_all.new_zeros((nb_new, 2 * size))
    if act:
        root = (rall[j:j + 1, 0].round().long(), rall[j:j + 1, 1], rall[j:j + 1, 2])
        zbuf2[j, lo:lo + csz] = _zhat(dfl, root, lo, csz)[0]
    zhat_all = coll.allreduce_sum(zbuf2, None, grid)

    lbuf = lam_all.new_zeros((nb_new, 2 * size))
    if act:
        zhat = zhat_all[j]
        ds, perm, defl = dfl.ds[0], dfl.perm[0], dfl.deflated[0]
        anchor, sgn, troot = (x[0] for x in root)
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
    rc, rs, rpi, ri = (x[0] for x in dfl.rots)
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

    lam_all, q_leaf, tol_scale = _leaves(d, e)          # replicated

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
                lam_loc, q_loc = _merge_level(lam_loc, q_loc, e, size, did * (nbatch // D2) // 2,
                                              tol_scale, laed4_iter)
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
    laed4_iter = laed4_iter_cap(d.dtype, laed4_iter)
    m, dp, ep = _dc_pad(d, e)
    lam, q = _tridiag_dc_dist_padded(dp, ep, laed4_iter, grid, col_align)
    return lam, q, m
