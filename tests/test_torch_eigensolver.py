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
    e, vs, taus = torch.zeros(10, 4), torch.zeros(8, 2, 8), torch.zeros(8, 2)
    for kw in ({"raw_bp": 128}, {"shifted": True}):
        with pytest.raises(NotImplementedError, match="slice 3"):
            bt.bt_band_to_tridiag(e, vs, taus, 8, **kw)


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
