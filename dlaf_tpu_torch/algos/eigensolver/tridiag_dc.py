"""Stage 3: symmetric tridiagonal eigensolver — Cuppen divide & conquer.

PyTorch counterpart of :mod:`dlaf_tpu.algos.eigensolver.tridiag_dc`
(reference ``eigensolver/tridiag_solver/impl.h`` + ``merge.h``): Cuppen
tears at every leaf boundary, leaves solved by cyclic Jacobi, then each
merge level processes all pairs of the level at once: deflation, the
secular equation solved per root (laed4 style, difference-first pole
arithmetic), Gu/Eisenstat z recomputation and one batched eigenvector GEMM.

Where the JAX package ``vmap``s over the leaves or the merges of a level,
the batch is a leading dimension written out here; where its batched
``while_loop`` freezes the members that have finished, the loops here
freeze them the same way, so each member stops at its own count. The
inherently sequential parts stay sequential loops on the device: the
Jacobi rotations, the deflation rotations and the laed4 iterations (one
device-to-host read per iteration to test convergence).

n is padded to LEAF * 2^L with decoupled, well-separated diagonal entries
that deflate trivially.
"""
from __future__ import annotations

import torch

LEAF = 32
# sweep budget: MIN is the fixed floor; the convergence check only EXTENDS
# the loop toward MAX while the off-diagonal mass is still far above its
# initial level (pathological clustering)
JACOBI_MIN_SWEEPS = 10
JACOBI_MAX_SWEEPS = 30


def _round_robin_schedule(n):
    """Static circle-method tournament: n-1 rounds of n/2 disjoint pairs."""
    assert n % 2 == 0
    players = list(range(n))
    rounds = []
    for _ in range(n - 1):
        partner = [0] * n
        for k in range(n // 2):
            i, j = players[k], players[n - 1 - k]
            partner[i] = j
            partner[j] = i
        rounds.append(partner)
        players = [players[0]] + [players[-1]] + players[1:-1]
    return rounds


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b, ...]] along the last dimension."""
    return torch.gather(x, -1, idx)


# ---------------------------------------------------------------------------
# leaf solver: cyclic Jacobi on a batch of small dense symmetric matrices


def _jacobi_eigh(a: torch.Tensor):
    """Eigendecomposition of a batch (L, n, n) of small dense symmetric
    matrices by cyclic (sequential-rotation) Jacobi, pairs (p, q) in
    row-major order. Returns (w (L, n) ascending, v (L, n, n)).

    Each rotation is a 2 x 2 product on rows p, q of A, then on its
    columns p, q and on the columns of V. At least JACOBI_MIN_SWEEPS sweeps
    run; a member keeps sweeping, up to JACOBI_MAX_SWEEPS, while its
    off-diagonal mass is above (8 eps)^2 of its starting mass, and the
    members that have stopped are held as they were.
    """
    nl, n, _ = a.shape
    a = a.clone()
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    v = eye.expand(nl, n, n).clone()
    offmask = 1.0 - eye
    eps = torch.finfo(a.dtype).eps

    def off_norm_sq(x):
        m = x * offmask
        return (m * m).sum((1, 2))

    off_tol = (8 * eps) ** 2 * off_norm_sq(a)
    pqs = [torch.tensor([p, q], device=a.device) for p in range(n - 1) for q in range(p + 1, n)]
    for it in range(JACOBI_MAX_SWEEPS):
        held = None
        if it >= JACOBI_MIN_SWEEPS:
            active = off_norm_sq(a) > off_tol
            if not bool(active.any()):
                break
            held = (active[:, None, None], a.clone(), v.clone())
        for pq in pqs:
            rows = a.index_select(1, pq)                         # rows p, q
            blk = rows.index_select(2, pq)
            app, apq, aqq = blk[:, 0, 0], blk[:, 0, 1], blk[:, 1, 1]
            zero_pq = apq == 0
            theta = (aqq - app) / (2 * torch.where(zero_pq, 1.0, apq))
            # range-safe tangent: past |theta| = 1e15 the angle is below
            # eps and the rotation is skipped; theta == 0 is 45 degrees
            at = theta.abs().clamp(max=1e15)
            t = torch.sign(theta) / (at + torch.sqrt(at * at + 1))
            t = torch.where((theta == 0) & ~zero_pq, 1.0,
                            torch.where((theta.abs() > 1e15) | zero_pq, 0.0, t))
            c = torch.rsqrt(t * t + 1)
            s = t * c
            rot = torch.stack([c, -s, s, c], dim=-1).view(nl, 2, 2)   # [[c, -s], [s, c]]
            a.index_copy_(1, pq, torch.bmm(rot, rows))
            rot_t = rot.mT
            a.index_copy_(2, pq, torch.bmm(a.index_select(2, pq), rot_t))
            v.index_copy_(2, pq, torch.bmm(v.index_select(2, pq), rot_t))
        if held is not None:
            keep, a0, v0 = held
            a = torch.where(keep, a, a0)
            v = torch.where(keep, v, v0)
    w = torch.diagonal(a, dim1=1, dim2=2)
    order = torch.argsort(w, dim=1, stable=True)
    return _gather(w, order), torch.gather(v, 2, order[:, None, :].expand(nl, n, n))


# ---------------------------------------------------------------------------
# merge: deflation + secular solve + eigenvector update


def _deflate(ds, zs, zsmall, tol):
    """The reference's close-eigenvalue rotation deflation over a batch
    (B, n) of sorted poles: scanning i upward, a surviving z_i whose pole
    lies within ``tol`` of the last survivor's is rotated into it.

    Same result as the JAX package's sequential scan, step for step. Only
    an index i whose previous non-small entry p(i) is within ``tol`` can
    rotate: for any other i the last survivor lies at or below p(i), so it
    is farther than ``tol`` as well. So the loop visits just those indices
    (every other index survives exactly where z_i is not small), in
    ascending order, with the scan's arithmetic.

    Returns (z after the rotations, rots = (c, s, prev or -1, i), each (B, n)).
    """
    bsz, n = ds.shape
    dev = ds.device
    idx = torch.arange(n, device=dev).expand(bsz, n)
    big = ~zsmall
    last_big = torch.cummax(torch.where(big, idx, -1), dim=1).values
    prev_big = torch.cat([torch.full((bsz, 1), -1, dtype=idx.dtype, device=dev),
                          last_big[:, :-1]], dim=1)
    cand = big & (prev_big >= 0) & \
        ((ds - _gather(ds, prev_big.clamp(min=0))) <= tol[:, None])
    surv = big & ~cand
    z = zs.clone()
    c_a = torch.ones_like(zs)
    s_a = torch.zeros_like(zs)
    pi_a = torch.full((bsz, n), -1, dtype=idx.dtype, device=dev)
    for i in torch.nonzero(cand.any(0)).flatten().tolist():
        prev = torch.where(surv[:, :i], idx[:, :i], -1).amax(1)
        pc = prev.clamp(min=0)[:, None]
        zi = z[:, i]
        zp = _gather(z, pc)[:, 0]
        close = (ds[:, i] - _gather(ds, pc)[:, 0]) <= tol
        can = cand[:, i] & (prev >= 0) & close
        r = torch.sqrt(zi * zi + zp * zp)
        rsafe = torch.where(r > 0, r, torch.ones_like(r))
        c_a[:, i] = torch.where(can, zp / rsafe, 1.0)
        s_a[:, i] = torch.where(can, zi / rsafe, 0.0)
        pi_a[:, i] = torch.where(can, prev, -1)
        z.scatter_(1, pc, torch.where(can, r, zp)[:, None])
        z[:, i] = torch.where(can, 0.0, zi)
        surv[:, i] = torch.where(cand[:, i], ~can, surv[:, i])
    return z, (c_a, s_a, pi_a, idx)


def _merge(d, z, rho, tol_scale, laed4_iter: int):
    """Eigen-analysis of diag(d) + rho z z^T (rho >= 0) with deflation, for
    a batch (B, n) of merges.

    Returns (lam, zhat, ds, perm, root, deflated, rots); eigenvalues are
    lam = ds + mu in d-sorted order (not resorted yet).
    """
    bsz, n = d.shape
    dt = d.dtype
    dev = d.device
    fi = torch.finfo(dt)
    eps, tiny = fi.eps, fi.tiny

    perm = torch.argsort(d, dim=1, stable=True)
    ds = _gather(d, perm)
    zs = _gather(z, perm)

    normz2 = (zs * zs).sum(1)
    dspread = torch.clamp(ds[:, -1] - ds[:, 0], min=eps)
    tol = 8.0 * eps * torch.maximum(tol_scale, dspread)

    # 1) z-threshold deflation, 2) close-eigenvalue rotation deflation
    zsmall = (rho[:, None] * zs).abs() <= tol[:, None]
    zs2, rots = _deflate(ds, zs, zsmall, tol)
    deflated = ((rho[:, None] * zs2).abs() <= tol[:, None]) | (zs2 == 0)
    zmask = torch.where(deflated, 0.0, zs2)

    # 3) secular roots: f(lam) = 1 + rho sum_j zmask_j^2/(ds_j - lam), one
    #    root per survivor i in (ds_i, ds_next_i), anchored at the nearer
    #    pole: lam_i = ds[anchor_i] + sign_i * t_i
    idx = torch.arange(n, device=dev).expand(bsz, n)
    masked_idx = torch.where(deflated, n, idx)
    sufmin = torch.flip(torch.cummin(torch.flip(masked_idx, [1]), dim=1).values, [1])
    next_idx = torch.cat([sufmin[:, 1:], torch.full((bsz, 1), n, device=dev,
                                                    dtype=idx.dtype)], dim=1)
    has_next = next_idx < n
    next_i = next_idx.clamp(max=n - 1)
    top_delta = rho * normz2 * (1 + 4 * eps) + tol
    delta = torch.where(has_next, _gather(ds, next_i) - ds, top_delta[:, None])
    delta = torch.clamp(delta, min=tiny)

    z2r = zmask * zmask
    tiny4 = tiny * 1e4
    rho_ = rho[:, None]

    def guard(den):
        return torch.where(den.abs() < tiny4,
                           torch.where(den < 0, -tiny4, tiny4), den)

    # side decision at the midpoint, pole differences first (LAPACK dlaed4)
    den = (ds[:, None, :] - ds[:, :, None]) - (0.5 * delta)[:, :, None]
    fmid = 1.0 + rho_ * (z2r[:, None, :] / guard(den)).sum(2)
    del den
    right = (fmid < 0) & has_next
    anchor = torch.where(right, next_i, idx)
    sgn = torch.where(right, -1.0, 1.0).to(dt)
    ds_anchor = _gather(ds, anchor)
    dd_a = ds[:, None, :] - ds_anchor[:, :, None]     # dd_a[b, i, j] = ds_j - ds[anchor_i]
    w_own = _gather(z2r, anchor)
    own = anchor[:, :, None] == idx[:, None, :]
    tmax = torch.where(right | has_next, 0.5 * delta, delta)

    def g_parts(t):
        """g(t) = sign * f(ds_anchor + sign t): increasing in t; plus parts."""
        safe = guard(dd_a - (sgn * t)[:, :, None])
        terms = z2r[:, None, :] / safe
        f = 1.0 + rho_ * terms.sum(2)
        df = rho_ * (z2r[:, None, :] / (safe * safe)).sum(2)
        s_no_own = 1.0 + rho_ * torch.where(own, 0.0, terms).sum(2)
        return sgn * f, df, s_no_own

    lo = torch.zeros_like(ds)
    hi = tmax
    t = 0.5 * tmax
    fp_sign = torch.where(right, -1.0, 1.0).to(dt)
    for _ in range(laed4_iter):
        # a merge stops once every bracket is resolved to relative machine
        # precision; stopped merges are held as they are
        live = ((hi - lo) > 2 * eps * t.abs() + tiny).any(1)
        if not bool(live.any()):
            break
        g, df, s_no_own = g_parts(t)
        lo_n = torch.where(g < 0, t, lo)
        hi_n = torch.where(g < 0, hi, t)
        newton = t - g / torch.clamp(df, min=tiny)
        # fixed point absorbing the anchor's own pole
        fp_den = fp_sign * s_no_own
        fp = rho_ * w_own / torch.where(fp_den > 0, fp_den, torch.inf)
        t_n = torch.where((fp > lo_n) & (fp < hi_n), fp, 0.5 * (lo_n + hi_n))
        t_n = torch.where((newton > lo_n) & (newton < hi_n), newton, t_n)
        keep = live[:, None]
        lo = torch.where(keep, lo_n, lo)
        hi = torch.where(keep, hi_n, hi)
        t = torch.where(keep, t_n, t)
    troot = torch.where(deflated, 0.0, t)
    anchor = torch.where(deflated, idx, anchor)
    sgn = torch.where(deflated, 1.0, sgn)
    ds_anchor = _gather(ds, anchor)
    lam = ds_anchor + sgn * troot
    # mu := lam - ds_i, exact when left-anchored (= troot)
    mu = torch.where(right & ~deflated, delta - troot, troot)

    # 4) Gu/Eisenstat zhat: zhat_i^2 = mu_i prod_{j != i} (lam_j - ds_i)/(ds_j - ds_i),
    #    lam_j - ds_i formed through the anchored representation
    offdiag = ~torch.eye(n, dtype=torch.bool, device=dev)
    num = (ds_anchor[:, None, :] - ds[:, :, None]) + (sgn * troot)[:, None, :]
    dd = ds[:, None, :] - ds[:, :, None]              # dd[b, i, j] = ds_j - ds_i
    ratio = torch.where(offdiag & (dd != 0), num / torch.where(dd != 0, dd, 1.0), 1.0)
    del num, dd
    prod = torch.prod(ratio, dim=2)
    del ratio
    zhat2 = torch.clamp(mu * prod, min=0.0)
    zhat = torch.where(deflated, 0.0, torch.sign(zs2) * torch.sqrt(zhat2))

    return lam, zhat, ds, perm, (anchor, sgn, troot), deflated, rots


def _merge_vectors(qleft_t, qright_t, lam, zhat, perm, root, deflated, rots, ds):
    """Assemble eigenvectors after a batch of merges and sort ascending.

    The eigenvector matrix is carried TRANSPOSED (qT[j, r] = q[r, j]):
    deflation rotations and permutations act on columns of q, rows of qT.
    The rank-one table qv (n x n per merge) is formed whole; at the 80 GB
    of an H100 it fits at every size the local driver takes.
    """
    bsz, n = lam.shape
    dt = lam.dtype
    dev = lam.device
    n1 = qleft_t.shape[1]
    qcat = lam.new_zeros((bsz, n, n))
    qcat[:, :n1, :n1] = qleft_t
    qcat[:, n1:, n1:] = qright_t
    bidx = torch.arange(bsz, device=dev)[:, None]
    qt = qcat[bidx, perm]                      # qt[k] = qcat[perm[k]]
    del qcat

    # the deflation rotations in scan order, valid ones first
    c_a, s_a, pi_a, i_a = rots
    validm = pi_a >= 0
    order_r = torch.argsort((~validm).to(torch.int8), dim=1, stable=True)
    c_a, s_a, pi_a, i_a = (_gather(x, order_r) for x in (c_a, s_a, pi_a, i_a))
    nvalid = validm.sum(1)
    b1 = bidx[:, 0]
    for k in range(int(nvalid.max()) if bsz else 0):
        on = (k < nvalid)[:, None]
        c, s = c_a[:, k, None], s_a[:, k, None]
        p, i = pi_a[:, k].clamp(min=0), i_a[:, k]
        rowp, rowi = qt[b1, p], qt[b1, i]
        qt[b1, p] = torch.where(on, c * rowp + s * rowi, rowp)
        qt[b1, i] = torch.where(on, -s * rowp + c * rowi, rowi)

    # rank-one eigenvectors: qv[j, i] = zhat_j / (ds_j - lam_i), with
    # ds_j - lam_i = (ds_j - ds_anchor_i) - sgn_i * troot_i
    anchor, sgn, troot = root
    eps = torch.finfo(dt).eps
    den = (ds[:, :, None] - _gather(ds, anchor)[:, None, :]) - (sgn * troot)[:, None, :]
    qv = zhat[:, :, None] / torch.where(den == 0, eps, den)
    del den
    eye = torch.eye(n, dtype=dt, device=dev)
    qv = torch.where(deflated[:, None, :], eye, qv)
    ssq = (qv * qv).sum(1)
    # qnewT[i, r] = sum_j qv[j, i] qT[j, r]; column normalization as a row scaling
    qnew_t = torch.matmul(qv.mT, qt)
    del qv, qt
    norm = torch.sqrt(ssq)
    qnew_t /= torch.where(norm > 0, norm, 1.0)[:, :, None]
    order = torch.argsort(lam, dim=1, stable=True)
    return _gather(lam, order), qnew_t[bidx, order]


# ---------------------------------------------------------------------------
# driver


def _tridiag_dc_padded(d, e, laed4_iter: int):
    m = d.shape[0]
    size = LEAF
    while size < m:
        size *= 2
    assert size == m, (m, LEAF)

    # Cuppen tears at every leaf boundary, applied up front (diagonal-only)
    nblocks = m // LEAF
    dmod = d.clone()
    if nblocks > 1:
        bidx = torch.arange(1, nblocks, device=d.device) * LEAF
        rho_all = e[bidx - 1].abs()
        dmod[bidx - 1] += -rho_all
        dmod[bidx] += -rho_all

    dleaf = dmod.reshape(nblocks, LEAF)
    eleaf = e.reshape(nblocks, LEAF)[:, :-1]
    tmats = torch.diag_embed(dleaf) + torch.diag_embed(eleaf, 1) + torch.diag_embed(eleaf, -1)
    lam, q = _jacobi_eigh(tmats)
    q = q.mT.contiguous()               # transposed storage (see _merge_vectors)

    tol_scale = d.abs().max() + 2 * e.abs().max()
    size = LEAF
    while lam.shape[0] > 1:
        nb2 = lam.shape[0] // 2
        lam1, lam2 = lam[0::2], lam[1::2]
        q1, q2 = q[0::2], q[1::2]
        bnd = torch.arange(nb2, device=d.device) * (2 * size) + size
        ecut = e[bnd - 1]
        rho = ecut.abs()
        theta = torch.where(ecut >= 0, 1.0, -1.0).to(d.dtype)
        dcat = torch.cat([lam1, lam2], dim=1)
        zcat = torch.cat([theta[:, None] * q1[:, :, -1], q2[:, :, 0]], dim=1)
        lamv, zhat, ds, perm, root, defl, rots = _merge(dcat, zcat, rho, tol_scale,
                                                         laed4_iter)
        lam, q = _merge_vectors(q1, q2, lamv, zhat, perm, root, defl, rots, ds)
        size *= 2
    return lam[0], q[0].mT


def laed4_iter_cap(dtype, laed4_iter: int) -> int:
    """Bisection-resolution cap by dtype: a bracket resolves in ~mantissa
    bits worth of halvings, so f32 never needs the f64-sized budget."""
    return min(laed4_iter, 48) if dtype == torch.float32 else laed4_iter


def tridiag_eigh(d: torch.Tensor, e: torch.Tensor, laed4_iter: int = 120):
    """Full eigendecomposition of the symmetric tridiagonal (d, e).

    Reference: ``dlaf::eigensolver::internal::TridiagSolver``
    (``tridiag_solver/impl.h:198``). Returns (eigenvalues ascending,
    eigenvectors as columns), over f32/f64.
    """
    laed4_iter = laed4_iter_cap(d.dtype, laed4_iter)
    n = d.shape[0]
    dt = d.dtype
    m = LEAF
    while m < n:
        m *= 2
    emax = e.abs().max() if n > 1 else d.new_zeros(())
    gersh = d.abs().max() + 2 * emax
    padvals = gersh + 1.0 + torch.arange(m - n, dtype=dt, device=d.device)
    dp = torch.cat([d, padvals])
    ep = d.new_zeros((m,))
    if n > 1:
        ep[:n - 1] = e
    lam, q = _tridiag_dc_padded(dp, ep, laed4_iter)
    return lam[:n], q[:n, :n]
