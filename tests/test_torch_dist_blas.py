"""The port's distributed BLAS-3 and data-model exchanges against the JAX
package's.

The same numpy inputs go through the JAX functions on the CPU device mesh
(as tests/test_dist_trsm.py, test_dist_trsm_right.py,
test_dist_multiplication.py, test_dist_matrix.py and test_aux.py run them)
and through the port on process grids: the 1x1 grid in this process, and
2x2, 2x3 and 2x4 grids of gloo ranks spawned by ``spawn_grid``, one spawn
per grid, in a background thread while the JAX references run.

Cases, with n not a multiple of nb on every grid: ``DistMatrix.transpose``
(conj and not; square grids swap shards, 2x3 (gcd 1) and 2x4 (gcd 2) run
the tile-slot all-to-all), ``symmetrize`` L/U and ``ring_shift`` on both
axes with shift +1 and -1, all bit-equal to JAX; ``triangular_solver``
(the 6 left uplo/trans cases on every grid, the right ones on 2x2 and 2x3,
a unit diagonal, alpha != 1, one complex128 case); ``general``,
``hermitian`` (L/U) and ``triangular_multiplication`` (L/R x L/U x N/U);
``generalized_to_standard_dist`` L/U; ``max_norm`` (G/L/U on 2x3, G on
1x1) and ``permute`` of rows and columns (bit-equal); and MULTICHIP_r05.json's trsm and gemm
checks (2x4, n = 64, nb = 8, on the distributed Cholesky factor). Each
result is held to JAX's within the JAX test's ``tol`` and to its own
residual gate; triangles that no call may read hold poison values.
"""
import concurrent.futures
import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from dlaf_tpu.algos import general as jax_general
from dlaf_tpu.algos import norm as jax_norm
from dlaf_tpu.algos import permutations as jax_perm
from dlaf_tpu.algos.cholesky import cholesky as jax_cholesky
from dlaf_tpu.algos.gen_to_std import generalized_to_standard_dist as jax_gen_to_std
from dlaf_tpu.algos.triangular import triangular_solver as jax_trsm
from dlaf_tpu.comm import collectives as jax_coll
from dlaf_tpu.comm.mesh import COL_AXIS, ROW_AXIS
from dlaf_tpu.comm.mesh import Grid as JaxGrid
from dlaf_tpu.matrix.dist_matrix import DistMatrix as JaxDistMatrix
from dlaf_tpu_torch.comm.launch import spawn_grid
from dlaf_tpu_torch.comm.mesh import Grid

import torch_dist_ranks as ranks
from conftest import tol

F32, F64, C128 = np.float32, np.float64, np.complex128
GRIDS = [(1, 1), (2, 2), (2, 3), (2, 4)]
EXACT = ("transpose", "symmetrize", "ring", "norm", "permute")


def _rng(key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _general(rng, shape, dtype):
    x = rng.uniform(-1, 1, shape)
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.uniform(-1, 1, shape)
    return x.astype(dtype)


def _hermitian(rng, n, dtype):
    x = _general(rng, (n, n), dtype)
    return ((x + x.conj().T) / 2).astype(dtype)


def _triangular(rng, n, dtype, lower, unit):
    """Well-conditioned triangular A as the generators make it, with poison
    in the triangle no call may read (and on a unit diagonal)."""
    t = _general(rng, (n, n), dtype) / n
    t = np.tril(t, -1) if lower else np.triu(t, 1)
    t = t + np.diag(rng.uniform(1, 2, n))
    stored = t.copy()
    poison = np.full((n, n), 5.0, dtype)
    stored += np.triu(poison, 1) if lower else np.tril(poison, -1)
    if unit:
        np.fill_diagonal(stored, 3.0)
        np.fill_diagonal(t, 1.0)
    return stored.astype(dtype), t.astype(dtype)


def _spd(rng, n, dtype):
    return (_hermitian(rng, n, dtype) + n * np.eye(n)).astype(dtype)


def _cases():
    """[(grid, key, kind, arrays, kw, reference info)]."""
    out = []

    def add(gs, key, kind, arrays, kw, **info):
        out.append((gs, f"{gs[0]}x{gs[1]}-{key}", kind, arrays, kw, info))

    for gs in GRIDS:
        r = _rng(gs)
        add(gs, "transpose-f64", "transpose", (_general(r, (85, 50), F64),),
            dict(nb=16, conj=False))
        c = _general(r, (70, 37), C128)
        for conj in (True, False):
            add(gs, f"transpose-c128-conj{conj}", "transpose", (c,), dict(nb=16, conj=conj))
        s = _general(r, (53, 53), C128)
        for lower in (True, False):
            add(gs, f"symmetrize-{'L' if lower else 'U'}", "symmetrize", (s,),
                dict(nb=16, lower=lower))
        if gs != (1, 1):
            for axis in (ROW_AXIS, COL_AXIS):
                for shift in (1, -1):
                    add(gs, f"ring-{axis}{shift:+d}", "ring", (), dict(axis=axis, shift=shift))
        # triangular solver: the 6 left cases on every grid, n ragged
        for uplo in "LU":
            for trans in "NTC":
                a, a_read = _triangular(r, 85, F64, uplo == "L", False)
                b = _general(r, (85, 43), F64)
                add(gs, f"trsm-L{uplo}{trans}N", "trsm", (a, b),
                    dict(nb=16, side="L", uplo=uplo, trans=trans, diag="N", alpha=2.0),
                    a_read=a_read, factor=100)
        if gs in ((2, 2), (2, 3)):
            for uplo in "LU":
                for trans in "NTC":
                    a, a_read = _triangular(r, 70, F64, uplo == "L", False)
                    b = _general(r, (43, 70), F64)
                    add(gs, f"trsm-R{uplo}{trans}N", "trsm", (a, b),
                        dict(nb=16, side="R", uplo=uplo, trans=trans, diag="N", alpha=1.5),
                        a_read=a_read, factor=200)
        if gs == (2, 3):
            a, a_read = _triangular(r, 85, F64, False, True)
            add(gs, "trsm-LUTU", "trsm", (a, _general(r, (85, 43), F64)),
                dict(nb=16, side="L", uplo="U", trans="T", diag="U", alpha=-0.5),
                a_read=a_read, factor=100)
        if gs == (2, 2):
            a, a_read = _triangular(r, 70, C128, True, False)
            add(gs, "trsm-LLCN-c128", "trsm", (a, _general(r, (70, 37), C128)),
                dict(nb=16, side="L", uplo="L", trans="C", diag="N", alpha=1.0 + 0.5j),
                a_read=a_read, factor=100)
            a, a_read = _triangular(r, 70, C128, False, False)
            add(gs, "trsm-RUCN-c128", "trsm", (a, _general(r, (37, 70), C128)),
                dict(nb=16, side="R", uplo="U", trans="C", diag="N", alpha=1.0 - 2j),
                a_read=a_read, factor=200)
        # multiplications
        gdt = F32 if gs in ((1, 1), (2, 3)) else F64
        add(gs, f"gemm-{np.dtype(gdt).name}", "gemm",
            (_general(r, (70, 45), gdt), _general(r, (45, 37), gdt), _general(r, (70, 37), gdt)),
            dict(nb=16, alpha=2.0, beta=-1.0))
        hdt = C128 if gs == (2, 3) else F64
        h = _hermitian(r, 70, hdt)
        for uplo in "LU":
            poison = np.full((70, 70), 7.0, hdt)
            stored = np.tril(h) + np.triu(poison, 1) if uplo == "L" else \
                np.triu(h) + np.tril(poison, -1)
            add(gs, f"hemm-{uplo}", "hemm", (stored, _general(r, (70, 37), hdt)),
                dict(nb=16, uplo=uplo, alpha=0.5), a_read=h)
        trmm = [(s, u, d) for s in "LR" for u in "LU" for d in "NU"] \
            if gs in ((2, 2), (2, 3)) else [("L", "L", "N"), ("R", "U", "U")]
        for side, uplo, diag in trmm:
            a, a_read = _triangular(r, 70, F64, uplo == "L", diag == "U")
            b = _general(r, (70, 37) if side == "L" else (37, 70), F64)
            add(gs, f"trmm-{side}{uplo}{diag}", "trmm", (a, b),
                dict(nb=16, side=side, uplo=uplo, diag=diag, alpha=1.5), a_read=a_read)
        h = _hermitian(r, 70, F64)
        bm = _spd(r, 70, F64)
        for uplo in "LU":
            f = np.linalg.cholesky(bm)
            f = f if uplo == "L" else f.conj().T
            add(gs, f"gen_to_std-{uplo}", "gen_to_std", (h, f), dict(nb=16, uplo=uplo))
        # max_norm compiles a shard_map program a call on the JAX side
        # (~2.5 s): all three on the non-square grid, G on the 1x1 one
        x = _general(r, (50, 45), F64)
        for uplo in {(2, 3): "GLU", (1, 1): "G"}.get(gs, ""):
            add(gs, f"norm-{uplo}", "norm", (x,), dict(nb=16, uplo=uplo))
        y = _general(r, (37, 29), F64)
        add(gs, "permute-rows", "permute", (y, r.permutation(37)), dict(nb=8, axis=0))
        add(gs, "permute-cols", "permute", (y, r.permutation(29)), dict(nb=8, axis=1))
    # MULTICHIP_r05.json's trsm and gemm (dryrun_multichip, __graft_entry__.py:56-111)
    r = _rng("multichip")
    add((2, 4), "multichip", "multichip", (_spd(r, 64, F64), _general(r, (64, 32), F64)),
        dict(nb=8))
    return out


CASES = _cases()
IDS = [c[1] for c in CASES]


def _run_port():
    """{key: result}, rank 0's for gathered results, and {key: [value of
    each rank]} for the ring cases."""
    out, ring = {}, {}
    for gs in GRIDS:
        cases = [(key, kind, arrays, kw) for g, key, kind, arrays, kw, _ in CASES if g == gs]
        if gs == (1, 1):
            res = [ranks.dist_blas_cases(cases, Grid(gs), torch.device("cpu"))]
        else:
            res = spawn_grid(functools.partial(ranks.dist_blas_cases, cases), gs,
                             backend="gloo", device="cpu", timeout=600)
        out.update(res[0])
        for key, kind, _, _ in cases:
            if kind == "ring":
                ring[key] = [r[key] for r in res]
    return out, ring


def _jax(gs, kind, arrays, kw):
    grid = JaxGrid(gs)
    nb = kw.get("nb")

    def dm(x, pad=False):
        return JaxDistMatrix.from_global(jnp.asarray(x), nb, grid, pad_identity=pad)

    if kind == "transpose":
        t = dm(arrays[0]).transpose(conj=kw["conj"])
        return np.asarray(t.to_global()), t.dist.size, t.dist.block_size, t.local_shape
    if kind == "symmetrize":
        return np.asarray(dm(arrays[0]).symmetrize(lower=kw["lower"]).to_global())
    if kind == "ring":
        P, Q = gs
        spec = PartitionSpec(ROW_AXIS, COL_AXIS, None)
        x = jnp.arange(P * Q, dtype=jnp.float32).reshape(P, Q, 1)
        fn = jax.shard_map(lambda v: jax_coll.ring_shift(v, kw["axis"], kw["shift"]),
                           mesh=grid.mesh, in_specs=spec, out_specs=spec)
        return np.asarray(fn(x)).reshape(-1).tolist()
    if kind == "trsm":
        a, b = arrays
        return np.asarray(jax_trsm(dm(a, True), dm(b), side=kw["side"], uplo=kw["uplo"],
                                   trans=kw["trans"], diag=kw["diag"],
                                   alpha=kw["alpha"]).to_global())
    if kind == "gemm":
        a, b, c = arrays
        return np.asarray(jax_general.general_multiplication(
            dm(a), dm(b), dm(c), alpha=kw["alpha"], beta=kw["beta"]).to_global())
    if kind == "hemm":
        a, b = arrays
        return np.asarray(jax_general.hermitian_multiplication(
            dm(a), dm(b), uplo=kw["uplo"], alpha=kw["alpha"]).to_global())
    if kind == "trmm":
        a, b = arrays
        return np.asarray(jax_general.triangular_multiplication(
            dm(a), dm(b), side=kw["side"], uplo=kw["uplo"], diag=kw["diag"],
            alpha=kw["alpha"]).to_global())
    if kind == "gen_to_std":
        a, l = arrays
        return np.asarray(jax_gen_to_std(dm(a), dm(l, True), uplo=kw["uplo"]).to_global())
    if kind == "norm":
        return float(jax_norm.max_norm(dm(arrays[0]), uplo=kw["uplo"]))
    if kind == "permute":
        return np.asarray(jax_perm.permute(dm(arrays[0]), arrays[1],
                                           axis=kw["axis"]).to_global())
    if kind == "multichip":
        a, b = arrays
        da, db = dm(a, True), dm(b)
        f = jax_cholesky(da)
        x = jax_trsm(f, db, uplo="L", trans="N")
        c = jax_general.general_multiplication(da, db)
        return tuple(np.asarray(m.to_global()) for m in (f, x, c))
    raise ValueError(kind)


@pytest.fixture(scope="module")
def results():
    """The port's results (spawned in a background thread) and JAX's."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(_run_port)
        jax_refs = {key: _jax(gs, kind, arrays, kw) for gs, key, kind, arrays, kw, _ in CASES}
        return port.result(), jax_refs


def _numpy_ref(kind, arrays, kw, info):
    """The result in numpy f64/c128 arithmetic."""
    if kind == "trsm":
        a = info["a_read"]
        opa = {"N": a, "T": a.T, "C": a.conj().T}[kw["trans"]]
        b = kw["alpha"] * arrays[1]
        return np.linalg.solve(opa, b) if kw["side"] == "L" else np.linalg.solve(opa.T, b.T).T
    if kind == "gemm":
        a, b, c = (x.astype(np.float64) for x in arrays)
        return kw["alpha"] * a @ b + kw["beta"] * c
    if kind == "hemm":
        return kw["alpha"] * info["a_read"] @ arrays[1]
    if kind == "trmm":
        a, b = info["a_read"], arrays[1]
        return kw["alpha"] * (a @ b if kw["side"] == "L" else b @ a)
    if kind == "gen_to_std":
        h, f = arrays
        linv = np.linalg.inv(f if kw["uplo"] == "L" else f.conj().T)
        return linv @ h @ linv.conj().T
    raise ValueError(kind)


def _size(kind, arrays, kw):
    """The order that scales the JAX test's tol: n of A (the inner size k
    for gemm)."""
    if kind == "gemm":
        return arrays[0].shape[1]
    return arrays[0].shape[0]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_matches_jax(results, case):
    (port, ring), jax_refs = results
    gs, key, kind, arrays, kw, info = case
    want = jax_refs[key]
    if kind == "ring":
        # rank at (p, q) received the tensor of its neighbour, as under JAX
        assert ring[key] == want, (ring[key], want)
        return
    got = port[key]
    if kind == "transpose":
        assert got[1:] == want[1:], (got[1:], want[1:])   # size, blocks, local shape
        np.testing.assert_array_equal(got[0], want[0])
        ref = arrays[0].conj().T if kw["conj"] else arrays[0].T
        np.testing.assert_array_equal(got[0], ref)
        return
    if kind in EXACT:
        if kind == "norm":
            assert got == want, (got, want)
        else:
            np.testing.assert_array_equal(got, want)
        return
    if kind == "multichip":
        a, b = arrays
        n = a.shape[0]
        eps = np.finfo(np.float64).eps
        amax = np.abs(a).max()
        l = np.tril(got[0])
        x, c = got[1], got[2]
        xmax = max(np.abs(x).max(), 1.0)
        assert np.abs(l @ l.conj().T - a).max() < 100 * n * eps * amax
        assert np.abs(l @ x - b).max() < 100 * n * eps * amax * xmax
        assert np.abs(c - a @ b).max() < 100 * n * eps * amax
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=tol(np.float64, n, 100) * amax)
        return
    dtype = arrays[0].dtype
    n = _size(kind, arrays, kw)
    factor = info.get("factor", 500 if kind == "gen_to_std" else 100)
    bound = tol(dtype, n, factor)
    ref = _numpy_ref(kind, arrays, kw, info)
    scale = max(np.abs(ref).max(), 1.0)
    assert np.abs(got - ref).max() <= bound * scale, (key, np.abs(got - ref).max())
    assert np.abs(got - want).max() <= bound * scale, (key, np.abs(got - want).max())


def test_grid_cases_cover_every_kind():
    """Every grid runs every kind but the 1x1 grid's ring (the identity)
    and max_norm, which runs on 1x1 and 2x3."""
    kinds = {gs: {c[2] for c in CASES if c[0] == gs} for gs in GRIDS}
    every = {"transpose", "symmetrize", "trsm", "gemm", "hemm", "trmm", "gen_to_std",
             "permute"}
    for gs in GRIDS:
        assert every <= kinds[gs], gs
    assert all("ring" in kinds[gs] for gs in GRIDS[1:])
    assert {gs for gs in GRIDS if "norm" in kinds[gs]} == {(1, 1), (2, 3)}
