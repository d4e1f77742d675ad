"""The port's distributed tridiagonal D&C and wavefront stage 2 against the
JAX package's.

The same numpy inputs (seeded) go through the JAX functions on the CPU
device mesh, as tests/test_tridiag_dc_dist.py and tests/test_wavefront.py
run them, and through the port: the 1x1 grid in this process, spawned gloo
ranks on the 2x2, 2x3, 2x4 and 1x4 grids (one spawn per grid, in a
background thread while the JAX references run).

 - ``tridiag_eigh_dist`` (f32 and f64, n = 64 and 100, every grid but
   1x4): eigenvalues against JAX's entry by entry and against numpy,
   eigenvectors through orthogonality and residual, all within
   tol(dtype, n, 100) (test_tridiag_dc_dist.py's bound);
 - ``dc_dist_supported``, ``merge_tree_idle_fraction`` and ``pow2_floor``
   equal to JAX's on a table of sizes and rank counts;
 - the sweep-chunked record: chunks bit-equal to the rows of the full
   record, which matches JAX's;
 - ``band_to_tridiag_wavefront`` bit-equal to the port's sequential chase
   and matching JAX's wavefront chase (test_wavefront.py's shapes, f64 and
   c128); ``restripe`` equal to JAX's;
 - the compute-distributed stage 2 (``band_to_tridiag_dist_pipelined``) on
   2x4, 2x3 and 1x4: bit-equal to the port's sequential chase (d, e and
   the sweep-sharded record, padded sweeps with tau = 0), and matching
   JAX's.

"Matching JAX's" chase is entry by entry within tol(dtype, n, 100)
max(1, max|band|): the two packages round the chase's products in
different orders (test_wavefront.py holds one package's schedules to each
other bit for bit, which the port does above).
"""
import concurrent.futures
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlaf_tpu.algos.eigensolver import band_strips as jax_bs
from dlaf_tpu.algos.eigensolver import tridiag_dc_dist as jax_dc
from dlaf_tpu.algos.eigensolver.dist_stage23 import \
    band_to_tridiag_dist_pipelined as jax_pipelined
from dlaf_tpu.comm.mesh import Grid as JaxGrid
from dlaf_tpu_torch.algos.eigensolver import band_strips as bs
from dlaf_tpu_torch.algos.eigensolver import tridiag_dc_dist as dc
from dlaf_tpu_torch.comm.launch import spawn_grid
from dlaf_tpu_torch.comm.mesh import Grid

import torch_dist_ranks as ranks
from conftest import tol

GRIDS = [(1, 1), (2, 2), (2, 3), (2, 4), (1, 4)]
# (grid, n, dtype) of the D&C cases
DC = [((1, 1), 64, np.float64), ((2, 2), 64, np.float64), ((2, 2), 100, np.float32),
      ((2, 3), 64, np.float32), ((2, 3), 100, np.float64), ((2, 4), 64, np.float64)]
# (grid, n, b, dtype) of the pipelined stage-2 cases
PIPE = [((2, 4), 40, 3, np.float64), ((2, 3), 256, 16, np.float64),
        ((1, 4), 30, 4, np.complex128)]


def _tridiag(n, dtype, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n).astype(dtype), rng.standard_normal(n - 1).astype(dtype)


def _chase_bound(a, n):
    """The bound between the two packages' chases of band ``a``."""
    return tol(a.dtype, n, 100) * max(1.0, float(np.abs(a).max()))


def _band_matrix(n, b, dtype, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    if np.dtype(dtype).kind == "c":
        a = a + 1j * rng.standard_normal((n, n))
    a = a + a.conj().T
    r = np.arange(n)
    return np.where(np.abs(r[:, None] - r[None, :]) <= b, a, 0).astype(dtype)


def _cases():
    out = []
    for i, (gs, n, dtype) in enumerate(DC):
        d, e = _tridiag(n, dtype, i)
        out.append((gs, f"dc-{gs[0]}x{gs[1]}-{n}-{np.dtype(dtype).name}", "dc", (d, e), {}))
    for i, (gs, n, b, dtype) in enumerate(PIPE):
        strips = bs.band_to_strips(torch.from_numpy(_band_matrix(n, b, dtype, 10 + i)), b)
        out.append((gs, f"pipelined-{gs[0]}x{gs[1]}-{n}-{b}", "pipelined",
                    (strips.numpy(),), dict(n=n, b=b)))
    return out


CASES = _cases()


def _run_port():
    out = {}
    for gs in GRIDS:
        cases = [(key, kind, arrays, kw) for g, key, kind, arrays, kw in CASES if g == gs]
        if gs == (1, 1):
            out.update(ranks.tridiag_cases(cases, Grid(gs), torch.device("cpu")))
        else:
            out.update(spawn_grid(functools.partial(ranks.tridiag_cases, cases), gs,
                                  backend="gloo", device="cpu", timeout=600)[0])
    return out


def _jax(gs, kind, arrays, kw):
    mesh = JaxGrid(gs).mesh
    if kind == "dc":
        lam, q, m = jax_dc.tridiag_eigh_dist(jnp.asarray(arrays[0]), jnp.asarray(arrays[1]), mesh)
        return np.asarray(lam), np.asarray(q), m
    d, e, vs, taus = jax_pipelined(jnp.asarray(arrays[0]), kw["n"], kw["b"], mesh)
    return np.asarray(d), np.asarray(e), np.asarray(vs), np.asarray(taus)


@pytest.fixture(scope="module")
def results():
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(_run_port)
        jax_refs = {key: _jax(gs, kind, arrays, kw) for gs, key, kind, arrays, kw in CASES}
        return port.result(), jax_refs


@pytest.mark.parametrize("case", [c for c in CASES if c[2] == "dc"],
                         ids=[c[1] for c in CASES if c[2] == "dc"])
def test_tridiag_eigh_dist_matches_jax(results, case):
    port, jax_refs = results
    gs, key, _, (d, e), _ = case
    n = d.shape[0]
    lam, q, m = port[key]
    lam_j, _, m_j = jax_refs[key]
    assert m == m_j
    bound = tol(d.dtype, n, 100)
    t = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    qn, ln = q[:n, :n], lam[:n]
    assert np.abs(qn.T @ qn - np.eye(n)).max() <= bound
    assert np.abs(t @ qn - qn * ln[None, :]).max() <= bound
    ref = np.linalg.eigvalsh(t.astype(np.float64))
    assert np.abs(np.sort(ln) - ref).max() <= bound
    assert np.abs(lam - lam_j).max() <= bound
    # the padding columns past m (a rank count that does not divide m) are zero
    assert not q[:, m:].any()


@pytest.mark.parametrize("case", [c for c in CASES if c[2] == "pipelined"],
                         ids=[c[1] for c in CASES if c[2] == "pipelined"])
def test_pipelined_dist_matches_sequential(results, case):
    """Compute-distributed stage 2: bit-identical (d, e) and sweep-sharded
    record to the sequential chase; padded sweeps are no-ops; JAX's
    within the chase bound."""
    port, jax_refs = results
    gs, key, _, (strips,), kw = case
    n, b = kw["n"], kw["b"]
    d, e, vs, taus = port[key]
    d0, e0, vs0, t0 = bs.band_to_tridiag_strips(torch.from_numpy(strips), n, b)
    nsweeps = n - 2
    np.testing.assert_array_equal(d, d0.numpy())
    np.testing.assert_array_equal(e, e0.numpy())
    np.testing.assert_array_equal(vs[:nsweeps], vs0.numpy())
    np.testing.assert_array_equal(taus[:nsweeps], t0.numpy())
    assert not taus[nsweeps:].any()
    dj, ej, vj, tj = jax_refs[key]
    bound = _chase_bound(strips, n)       # the strips hold the band's entries
    for got, want in ((d, dj), (e, ej), (vs, vj), (taus, tj)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=bound)


def test_dc_dist_supported_and_idle_fraction():
    for ndev in (1, 2, 3, 4, 6, 8, 12, 64):
        assert dc.pow2_floor(ndev) == jax_dc.pow2_floor(ndev)
        assert dc.merge_tree_idle_fraction(ndev) == jax_dc.merge_tree_idle_fraction(ndev)
        for n in (31, 64, 100, 256):
            assert dc.dc_dist_supported(n, ndev) == jax_dc.dc_dist_supported(n, ndev)
    assert dc.merge_tree_idle_fraction(6) == pytest.approx(1 / 3)
    assert not dc.dc_dist_supported(31, 64)


def test_stage2_sweep_chunked_record():
    """Sweep-chunked records are bit-equal to rows of the full one, which
    matches JAX's; the last chunk's sweeps past the end read tau = 0."""
    n, b = 50, 8
    a = _band_matrix(n, b, np.float64, 0)
    strips = bs.band_to_strips(torch.from_numpy(a), b)
    d0, e0, vs0, t0 = bs.band_to_tridiag_strips(strips, n, b)
    nsweeps = n - 2
    chunk = -(-nsweeps // 4)
    parts = [bs.band_to_tridiag_strips(strips, n, b, sweep_lo=k * chunk, sweep_chunk=chunk)
             for k in range(4)]
    vs = torch.cat([p[2] for p in parts])
    taus = torch.cat([p[3] for p in parts])
    assert torch.equal(vs[:nsweeps], vs0) and torch.equal(taus[:nsweeps], t0)
    assert not taus[nsweeps:].any()
    for p in parts:
        assert torch.equal(p[0], d0) and torch.equal(p[1], e0)
    _, _, vj, tj = jax_bs.band_to_tridiag_strips(jax_bs.band_to_strips(jnp.asarray(a), b), n, b)
    np.testing.assert_allclose(vs0.numpy(), np.asarray(vj), rtol=0, atol=_chase_bound(a, n))
    np.testing.assert_allclose(t0.numpy(), np.asarray(tj), rtol=0, atol=_chase_bound(a, n))


@pytest.mark.parametrize("n,b,dtype", [(16, 2, np.float64), (24, 3, np.float64),
                                       (33, 4, np.float64), (20, 5, np.float64),
                                       (33, 4, np.complex128)])
def test_wavefront_matches_sequential(n, b, dtype):
    a = _band_matrix(n, b, dtype, 0)
    strips = bs.band_to_strips(torch.from_numpy(a), b)
    seq = bs.band_to_tridiag_strips(strips, n, b)
    wave = bs.band_to_tridiag_wavefront(strips, n, b)
    for x, y in zip(seq, wave):
        assert torch.equal(x, y)
    jw = jax_bs.band_to_tridiag_wavefront(jax_bs.band_to_strips(jnp.asarray(a), b), n, b)
    for x, y in zip(wave, jw):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0, atol=_chase_bound(a, n))
    # the step function itself: every chase of a step inside one segment
    assert bs.wavefront_nsteps(n, b) == jax_bs.wavefront_nsteps(n, b)
    assert bs.wavefront_k(7, b) == jax_bs.wavefront_k(7, b)


def test_restripe_matches_jax():
    n, nb, b = 96, 32, 8
    a = _band_matrix(n, b, np.float64, 1)
    s_nb = bs.band_to_strips(torch.from_numpy(a), nb)
    s_nb = torch.cat([s_nb, s_nb.new_zeros((3, nb, 5 * nb))])
    ns = bs.n_strips(n, b) + 3
    got = bs.restripe(s_nb, nb, b, ns)
    want = jax_bs.restripe(jnp.asarray(s_nb.numpy()), nb, b, ns)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # and the b-strips hold the band's strip storage
    assert torch.equal(got[:bs.n_strips(n, b)], bs.band_to_strips(torch.from_numpy(a), b))
