"""The eigensolver stages of the port against the JAX package: Householder
blocks, stage 1 (reduction to band), stage 3 (tridiagonal divide and
conquer) and the two back-transformations.

The same numpy inputs go to both packages. Tolerances are those of the JAX
tests (tests/test_eigensolver.py:44, tests/test_band_strips.py:70):
tol(dtype, n, 2000) * max(1, max|A|) for f32/c64 and tol(dtype, n, 200) *
max(1, max|A|) for f64/c128, with n the problem's order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlaf_tpu.algos.eigensolver import bt as jbt
from dlaf_tpu.algos.eigensolver import red2band as jr2b
from dlaf_tpu.algos.eigensolver import tridiag_dc as jdc
from dlaf_tpu.algos.eigensolver.band2tridiag import band_to_tridiag as jax_band_to_tridiag
from dlaf_tpu.ops import householder as jhh
from dlaf_tpu_torch.algos.eigensolver import bt
from dlaf_tpu_torch.algos.eigensolver import red2band as r2b
from dlaf_tpu_torch.algos.eigensolver import tridiag_dc as dc
from dlaf_tpu_torch.ops import householder as hh

from conftest import tol

LOW = (np.dtype("float32"), np.dtype("complex64"))


def _bound(dtype, n, a=None):
    factor = 2000 if np.dtype(dtype) in LOW else 200
    scale = 1.0 if a is None else max(1.0, float(np.max(np.abs(a))))
    return tol(dtype, n, factor) * scale


def _rand(rng, shape, dtype):
    x = rng.standard_normal(shape)
    if np.issubdtype(dtype, np.complexfloating):
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def _herm(rng, n, dtype):
    a = _rand(rng, (n, n), dtype)
    return ((a + a.conj().T) / 2).astype(dtype)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, bound):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == np.shape(want)
    assert np.abs(got - np.asarray(want)).max(initial=0) <= bound


# --------------------------------------------------------------- Householder


@pytest.mark.parametrize("head", [0, 3])
def test_householder_vector_matches_jax(dtype, head):
    x = _rand(np.random.default_rng(head), (17,), dtype)
    got = hh.householder_vector(_t(x), head)
    want = jhh.householder_vector(jnp.asarray(x), head)
    for g, w in zip(got, want):
        _close(g, w, _bound(dtype, 17, x))
    # larfg conventions: unit head, H x = beta e_head
    v, tau, beta = (g.numpy() for g in got)
    assert v[head] == 1 and np.all(v[:head] == 0)
    xm = np.where(np.arange(17) >= head, x, 0)
    hx = xm - tau.conj() * v * (v.conj() @ xm)   # H^H x for the complex convention
    want_hx = np.zeros_like(xm)
    want_hx[head] = beta
    assert np.abs(hx - want_hx).max() <= _bound(dtype, 17, x)


def test_householder_vector_of_zero():
    got = hh.householder_vector(torch.zeros(5, dtype=torch.float64))
    want = jhh.householder_vector(jnp.zeros(5, jnp.float64))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("m,b", [(40, 8), (8, 8), (5, 8)])
def test_panel_qr_matches_jax(dtype, m, b):
    p = _rand(np.random.default_rng(m), (m, b), dtype)
    got = hh.panel_qr(_t(p))
    want = jhh.panel_qr(jnp.asarray(p))
    for g, w in zip(got, want):
        _close(g, w, _bound(dtype, m, p))


def test_t_factor_matches_jax(dtype):
    p = _rand(np.random.default_rng(9), (48, 12), dtype)
    v, taus, _ = jhh.panel_qr(jnp.asarray(p))
    taus = np.array(taus)
    taus[5] = 0                                 # a column without reflector
    got = hh.t_factor(_t(v), _t(taus))
    want = jhh.t_factor(v, jnp.asarray(taus))
    _close(got, want, _bound(dtype, 48, p))
    assert np.all(got.numpy()[5] == 0) and np.all(got.numpy()[:, 5] == 0)
    # a batch of blocks gives the blocks' T factors
    vb = torch.stack([_t(v), 2 * _t(v)])
    tb = hh.t_factor(vb, torch.stack([_t(taus), _t(taus) / 4]))
    _close(tb[0], got.numpy(), _bound(dtype, 48, p))
    _close(tb[1], hh.t_factor(2 * _t(v), _t(taus) / 4).numpy(), _bound(dtype, 48, p))


# ----------------------------------------------------------------- stage 1


@pytest.mark.parametrize("n,b", [(48, 8), (32, 16), (16, 16)])
def test_reduction_to_band_matches_jax(dtype, n, b):
    a = _herm(np.random.default_rng(n + b), n, dtype)
    junk = np.triu(np.full_like(a, 99), 1)      # only the lower triangle is read
    got_p, got_t = r2b.reduction_to_band(_t(np.tril(a) + junk), b)
    want_p, want_t = jr2b.reduction_to_band(jnp.asarray(np.tril(a) + junk), b)
    bound = _bound(dtype, n, a)
    # the packed layout lives in the lower triangle (band + reflectors)
    _close(torch.tril(got_p), np.tril(np.asarray(want_p)), bound)
    _close(got_t, want_t, bound)
    _close(r2b.extract_band(got_p, b), jr2b.extract_band(want_p, b), bound)
    _close(r2b.extract_v(got_p, b), jr2b.extract_v(want_p, b), bound)


def test_reduction_to_band_is_a_similarity(dtype):
    """The band matrix has the input's eigenvalues."""
    n, b = 40, 8
    a = _herm(np.random.default_rng(3), n, dtype)
    packed, _ = r2b.reduction_to_band(_t(a), b)
    band = r2b.extract_band(packed, b).numpy()
    assert np.abs(np.linalg.eigvalsh(band) - np.linalg.eigvalsh(a)).max() <= _bound(dtype, n, a)


# ----------------------------------------------------------------- stage 3


def _tridiag(rng, n, dtype):
    return rng.standard_normal(n).astype(dtype), rng.standard_normal(n - 1).astype(dtype)


def _fix_signs(q):
    """Each column's sign made that of its largest entry (eigenvectors are
    unique up to sign)."""
    j = np.abs(q).argmax(0)
    return q * np.sign(q[j, np.arange(q.shape[1])])[None, :]


@pytest.mark.parametrize("n", [1, 7, 32, 64, 100])
def test_tridiag_eigh_matches_jax(real_dtype_p, n):
    d, e = _tridiag(np.random.default_rng(n), n, real_dtype_p)
    lam, q = dc.tridiag_eigh(_t(d), _t(e))
    lam0, q0 = jdc.tridiag_eigh(jnp.asarray(d), jnp.asarray(e))
    t = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    bound = _bound(real_dtype_p, n, t)
    _close(lam, lam0, bound)
    # random tridiagonals of this size have well separated eigenvalues
    _close(_fix_signs(q.numpy()), _fix_signs(np.asarray(q0)), bound)
    assert np.abs(t @ q.numpy() - q.numpy() * lam.numpy()[None, :]).max() <= bound


def test_tridiag_eigh_clustered_matches_jax(real_dtype_p):
    """Repeated and clustered eigenvalues: the deflation paths (small z,
    close-pole rotations) carry the result."""
    n = 96
    rng = np.random.default_rng(11)
    d = np.repeat([1.0, 2.0, 2.0 + 1e-9, 3.0], n // 4)[rng.permutation(n)].astype(real_dtype_p)
    e = (1e-3 * rng.standard_normal(n - 1)).astype(real_dtype_p)
    e[::5] = 0
    lam, q = dc.tridiag_eigh(_t(d), _t(e))
    lam0, _ = jdc.tridiag_eigh(jnp.asarray(d), jnp.asarray(e))
    t = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    bound = _bound(real_dtype_p, n, t)
    _close(lam, lam0, bound)
    qn = q.numpy()
    assert np.abs(qn.T @ qn - np.eye(n)).max() <= bound
    assert np.abs(t @ qn - qn * lam.numpy()[None, :]).max() <= bound


def _deflate_scan(ds, zs, zsmall, tol_):
    """The JAX package's deflation scan (tridiag_dc.py:191-208), step by
    step in numpy: the oracle of the port's _deflate."""
    z = zs.copy()
    n = len(z)
    prev = -1
    c_a, s_a, pi_a = np.ones(n, z.dtype), np.zeros(n, z.dtype), np.full(n, -1)
    for i in range(n):
        p = max(prev, 0)
        zi, zp = z[i], z[p]
        can = (not zsmall[i]) and prev >= 0 and (ds[i] - ds[p]) <= tol_
        r = np.sqrt(zi * zi + zp * zp)
        rsafe = r if r > 0 else z.dtype.type(1)
        if can:
            c_a[i], s_a[i], pi_a[i] = zp / rsafe, zi / rsafe, prev
            z[p], z[i] = r, 0
        elif not zsmall[i]:
            prev = i
    return z, c_a, s_a, pi_a


def test_deflate_equals_the_sequential_scan(real_dtype_p):
    rng = np.random.default_rng(5)
    bsz, n = 3, 64
    ds = np.sort(np.round(rng.uniform(0, 4, (bsz, n)), 1), axis=1).astype(real_dtype_p)
    zs = rng.standard_normal((bsz, n)).astype(real_dtype_p)
    zsmall = rng.uniform(size=(bsz, n)) < 0.2
    tol_ = np.array([0.05, 0.0, 0.25], real_dtype_p)
    z, (c_a, s_a, pi_a, i_a) = dc._deflate(_t(ds), _t(zs), torch.from_numpy(zsmall), _t(tol_))
    # the same rotations in the same order; values to 4 ulps, because
    # PyTorch's vectorized CPU sqrt may round differently from numpy's
    ulps = 4 * np.finfo(real_dtype_p).eps
    for k in range(bsz):
        wz, wc, ws, wp = _deflate_scan(ds[k], zs[k], zsmall[k], tol_[k])
        assert np.array_equal(pi_a[k].numpy(), wp)
        assert np.array_equal(i_a[k].numpy(), np.arange(n))
        assert np.array_equal(z[k].numpy() == 0, wz == 0)
        for got, want in ((z[k], wz), (c_a[k], wc), (s_a[k], ws)):
            assert np.all(np.abs(got.numpy() - want) <= ulps * np.abs(want))
    assert (pi_a >= 0).sum() >= 20            # the case exercises many rotations


def test_round_robin_schedule_matches_jax():
    for n in (2, 8, 32):
        assert dc._round_robin_schedule(n) == jdc._round_robin_schedule(n)


def test_jacobi_leaf_matches_jax(real_dtype_p):
    rng = np.random.default_rng(2)
    a = rng.standard_normal((3, 32, 32))
    a = ((a + a.transpose(0, 2, 1)) / 2).astype(real_dtype_p)
    w, v = dc._jacobi_eigh(_t(a))
    bound = _bound(real_dtype_p, 32, a)
    for k in range(3):
        w0, v0 = jdc._jacobi_eigh(jnp.asarray(a[k]))
        _close(w[k], w0, bound)
        _close(_fix_signs(v[k].numpy()), _fix_signs(np.asarray(v0)), bound)


def test_laed4_iter_cap():
    assert dc.laed4_iter_cap(torch.float32, 120) == jdc.laed4_iter_cap(jnp.float32, 120) == 48
    assert dc.laed4_iter_cap(torch.float64, 120) == jdc.laed4_iter_cap(jnp.float64, 120) == 120


def _merge_batch(dtype):
    """The deflation analysis of two merges of order 96 as one batch: a
    random one and a clustered one (repeated poles, tiny z entries)."""
    rng = np.random.default_rng(41)
    n = 96
    d = np.stack([rng.standard_normal(n),
                  np.repeat(rng.standard_normal(n // 8), 8) + 1e-13 * rng.standard_normal(n)])
    z = rng.standard_normal((2, n))
    z[1, rng.uniform(size=n) < 0.2] = 1e-14
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    d, z = _t(d.astype(dtype)), _t(z.astype(dtype))
    rho = _t(np.array([0.7, 1.3], dtype))
    return dc._deflation(d, z, rho, d.abs().max() + 2), rho


@pytest.mark.parametrize("chunks", [2, 3, 4])
def test_merge_analysis_by_chunks_matches_one_full_range_call(real_dtype_p, chunks):
    """The row-sharded top levels run the local merge's root solve and
    zhat on a chunk of the roots (rows); concatenated over the chunks they
    are one full-range call. Root by root the arithmetic is the same, so a
    fixed iteration budget gives the same bits. The stop rule is per
    range: a chunk whose brackets are all resolved stops where the full
    range may run on, so at the full budget each root lies within its
    resolved bracket, 2 eps |troot| + tiny, of the full range's. zhat is
    row by row: bit-equal."""
    dfl, rho = _merge_batch(real_dtype_p)
    assert dfl.deflated[1].any() and (dfl.rots[2][1] >= 0).any()
    assert not dfl.deflated[0].all()
    n = dfl.ds.shape[1]
    cuts = np.linspace(0, n, chunks + 1).astype(int)
    ranges = [(int(a), int(b - a)) for a, b in zip(cuts[:-1], cuts[1:])]
    for budget in (2, dc.laed4_iter_cap(dfl.ds.dtype, 120)):
        full = dc._secular_roots(dfl, rho, budget)
        parts = [dc._secular_roots(dfl, rho, budget, lo, csz) for lo, csz in ranges]
        anchor, sgn, troot = (torch.cat(p, 1) for p in zip(*parts))
        assert torch.equal(anchor, full[0]) and torch.equal(sgn, full[1])
        if budget == 2:
            assert torch.equal(troot, full[2])
        else:
            fi = torch.finfo(troot.dtype)
            assert ((troot - full[2]).abs() <= 2 * fi.eps * troot.abs() + fi.tiny).all()
    zhat = torch.cat([dc._zhat(dfl, full, lo, csz) for lo, csz in ranges], 1)
    assert torch.equal(zhat, dc._zhat(dfl, full))


def test_pad_helpers_match_the_inline_pads():
    """The D&C pad is what tridiag_eigh and tridiag_eigh_dist built inline;
    the matrix-level pad is what eigh and the gathered eigh_dist built
    inline, and the shard pad on a 1x1 grid writes the same matrix."""
    from dlaf_tpu_torch.algos.eigensolver import dist_stage23 as s23
    from dlaf_tpu_torch.algos.eigensolver.driver import pad_dense
    from dlaf_tpu_torch.comm.mesh import Grid

    rng = np.random.default_rng(3)
    for dtype in (np.float32, np.float64):
        for n, m in ((1, 32), (2, 32), (31, 32), (32, 32), (33, 64), (100, 128)):
            d, e = _tridiag(rng, n, dtype)
            gersh = np.abs(d).max() + 2 * (np.abs(e).max() if n > 1 else dtype(0))
            want_d = np.concatenate([d, gersh + 1 + np.arange(m - n, dtype=dtype)])
            want_e = np.zeros(m, dtype)
            want_e[:n - 1] = e
            got_m, got_d, got_e = dc._dc_pad(_t(d), _t(e))
            assert got_m == m
            assert torch.equal(got_d, _t(want_d)) and torch.equal(got_e, _t(want_e))
    for dtype in (np.float64, np.complex64):
        n, pm = 50, 64
        a = _t(_herm(rng, n, dtype))
        want = torch.zeros((pm, pm), dtype=a.dtype)
        want[:n, :n] = a
        want.diagonal()[n:] = (a.abs().max() * (n + 1) + 1.0
                               + torch.arange(pm - n, dtype=a.abs().dtype))
        assert torch.equal(pad_dense(a, pm), want)
        assert pad_dense(a, n) is a
        shard = torch.full((pm, pm), 7.0, dtype=a.dtype)
        shard[:n, :n] = a
        assert torch.equal(s23._pad_fix(shard, nb=16, n=n, pm=pm, grid=Grid((1, 1))), want)


# -------------------------------------------------------- back-transforms


def _record(n, b, dtype, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    if np.issubdtype(dtype, np.complexfloating):
        a = a + 1j * rng.standard_normal((n, n))
    a = a + a.conj().T
    i = np.arange(n)
    band = np.where(np.abs(i[:, None] - i[None, :]) <= b, a, 0).astype(dtype)
    _, _, vs, taus = jax_band_to_tridiag(jnp.asarray(band), b)
    e = _rand(rng, (n, 24), dtype)
    return np.array(vs), np.array(taus), e


@pytest.mark.parametrize("n,b,g", [(50, 8, 16), (37, 4, 64), (20, 16, 3)])
def test_bt_band_to_tridiag_matches_jax_and_sweepwise(dtype, n, b, g):
    vs, taus, e = _record(n, b, dtype, seed=n)
    got = bt.bt_band_to_tridiag(_t(e), _t(vs), _t(taus), b, group_size=g)
    bound = _bound(dtype, n, e)
    _close(got, jbt.bt_band_to_tridiag(jnp.asarray(e), jnp.asarray(vs), jnp.asarray(taus),
                                       b, group_size=g), bound)
    _close(got, bt.bt_band_to_tridiag_sweepwise(_t(e), _t(vs), _t(taus), b).numpy(), bound)
    _close(bt.bt_band_to_tridiag_sweepwise(_t(e), _t(vs), _t(taus), b),
           jbt.bt_band_to_tridiag_sweepwise(jnp.asarray(e), jnp.asarray(vs),
                                            jnp.asarray(taus), b), bound)


def test_bt_band_to_tridiag_sweep_chunks_and_prepadded(dtype):
    """Chunks of the record applied in descending sweep_lo order, on one
    prepadded buffer, give the whole record's result."""
    n, b, g = 66, 8, 16
    vs, taus, e = _record(n, b, dtype, seed=1)
    whole = bt.bt_band_to_tridiag(_t(e), _t(vs), _t(taus), b, group_size=g)
    win = b + g - 1
    ep = torch.cat([_t(e), torch.zeros((win, e.shape[1]), dtype=whole.dtype)])
    for lo in (48, 32, 16, 0):
        ep = bt.bt_band_to_tridiag(ep, _t(vs[lo:lo + 16]), _t(taus[lo:lo + 16]), b,
                                   group_size=g, sweep_lo=lo, prepadded=True)
    _close(ep[:n], whole.numpy(), _bound(dtype, n, e))


def test_bt_streaming_apply_not_ported():
    """The streaming apply (shifted, raw_bp) is ported since slice 3
    (tests/test_torch_bt_apply.py); what it cannot take, it refuses."""
    e, vs, taus = torch.zeros(10, 4), torch.zeros(8, 2, 8), torch.zeros(8, 2)
    with pytest.raises(ValueError, match="shifted apply"):        # b = 8: no kernel plan
        bt.bt_band_to_tridiag(e, vs, taus, 8, shifted=True)
    with pytest.raises(ValueError, match="raw record"):           # 7 sweeps, groups of 4
        bt.bt_band_to_tridiag(e, torch.zeros(8, 2, 128), taus, 8, group_size=4, raw_bp=128)


def test_wy_group_vt_places_the_selection(dtype):
    g, b = 5, 8
    rng = np.random.default_rng(4)
    vs_g = _rand(rng, (3, g, b), dtype)
    taus_g = _rand(rng, (3, g), dtype)
    v, t = bt.wy_group_vt(_t(vs_g), _t(taus_g))
    sel = bt.wy_select_tensor(g, b, torch.from_numpy(vs_g).dtype)
    assert np.array_equal(np.asarray(sel), np.asarray(jbt.wy_select_tensor(g, b, vs_g.dtype)))
    jsel = jbt.wy_select_tensor(g, b, vs_g.dtype)
    for k in range(3):
        vk = torch.einsum("rjt,jt->rj", sel.to(v.dtype), _t(vs_g[k]).flip(0))
        assert torch.equal(v[k], vk)
        v0, t0 = jbt.wy_group_vt(jnp.asarray(vs_g[k]), jnp.asarray(taus_g[k]), jsel)
        _close(v[k], v0, 0.0)
        _close(t[k], t0, _bound(dtype, b + g, t0))


@pytest.mark.parametrize("n,b,pg", [(48, 8, 4), (40, 8, 2), (32, 16, 4)])
def test_bt_reduction_to_band_matches_jax(dtype, n, b, pg):
    a = _herm(np.random.default_rng(n), n, dtype)
    packed, taus = jr2b.reduction_to_band(jnp.asarray(a), b)
    e = _rand(np.random.default_rng(n + 1), (n, 12), dtype)
    got = bt.bt_reduction_to_band(_t(e), _t(packed), _t(taus), b, panel_group=pg)
    want = jbt.bt_reduction_to_band(jnp.asarray(e), packed, taus, b, panel_group=pg)
    _close(got, want, _bound(dtype, n, e))
