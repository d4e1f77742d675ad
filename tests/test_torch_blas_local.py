"""The port's local BLAS-3 and auxiliaries against the JAX package on the
same numpy inputs: dlaf_tpu_torch.{trsm, trmm, herk, hemm, gemm} against
dlaf_tpu.{...} over the cases of tests/test_blas_local.py, blocked.her2k,
trsm_leaf on both routes, max_norm_local and permute_local.

Tolerances are conftest.tol with the JAX test's factor (100, or the
reference test's exact equality for the untouched triangle). Every call
also leaves the caller's tensors unchanged.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dlaf_tpu
import dlaf_tpu_torch
from dlaf_tpu.algos import norm as jnorm
from dlaf_tpu.algos import permutations as jperm
from dlaf_tpu.ops import blocked as jblocked
from dlaf_tpu_torch.algos.norm import max_norm_local
from dlaf_tpu_torch.algos.permutations import permute_local
from dlaf_tpu_torch.ops import blocked, leaf
from dlaf_tpu_torch.ops.kernels.trailing import ksub_matmul

from conftest import tol

DTYPES = ["float32", "float64", "complex64", "complex128"]


def _general(shape, dtype, seed):
    """Uniform in [-1, 1] (complex: both parts), the generators' law."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, shape)
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.uniform(-1, 1, shape)
    return x.astype(dtype)


def _hermitian(n, dtype, seed):
    r = _general((n, n), dtype, seed)
    return ((r + r.conj().T) / 2).astype(dtype)


def _triangular(n, dtype, lower, unit, seed):
    """generators.random_triangular's law: strict triangle over n, diagonal
    in [1, 2] (or ones), and 99 in the other triangle, which no call may
    read."""
    r = _general((n, n), dtype, seed)
    t = (np.tril(r, -1) if lower else np.triu(r, 1)) / n
    d = np.ones(n) if unit else np.random.default_rng(seed + 1).uniform(1, 2, n)
    poison = np.triu(np.full((n, n), 99.0), 1) if lower else np.tril(np.full((n, n), 99.0), -1)
    return (t + np.diag(d) + poison).astype(dtype)


def _norm(x):
    return float(np.max(np.abs(x))) if x.size else 0.0


def _call(fn, *arrays, **kw):
    """fn on torch copies of ``arrays``; checks the copies are unchanged
    after the call and returns the result as numpy."""
    ts = [None if x is None else torch.from_numpy(x.copy()) for x in arrays]
    out = fn(*ts, **kw)
    for x, t in zip(arrays, ts):
        if x is not None:
            np.testing.assert_array_equal(t.numpy(), x)
    return out.resolve_conj().numpy()


def _jax(fn, *arrays, **kw):
    return np.asarray(fn(*[None if x is None else jnp.asarray(x) for x in arrays], **kw))


def _check_trsm_trmm(m, n, side, uplo, trans, diag, dtype):
    na = m if side == "L" else n
    a = _triangular(na, dtype, uplo == "L", diag == "U", 7 * m + n)
    b = _general((m, n), dtype, 1)
    kw = dict(side=side, uplo=uplo, trans=trans, diag=diag, alpha=1.5, nb=64)
    bound = tol(dtype, max(m, n), 100)
    for name in ("trsm", "trmm"):
        got = _call(getattr(dlaf_tpu_torch, name), a, b, **kw)
        want = _jax(getattr(dlaf_tpu, name), a, b, **kw)
        assert got.shape == want.shape == (m, n)
        assert _norm(got - want) <= bound * max(1.0, _norm(want)), name


@pytest.mark.parametrize("case_dtype", ["float64", "complex128"])
@pytest.mark.parametrize("side", ["L", "R"])
@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("trans", ["N", "T", "C"])
@pytest.mark.parametrize("diag", ["N", "U"])
def test_trsm_trmm_cases_match_jax(side, uplo, trans, diag, case_dtype):
    _check_trsm_trmm(130, 70, side, uplo, trans, diag, np.dtype(case_dtype))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("m,n", [(1, 1), (7, 3), (64, 64), (96, 200)])
def test_trsm_trmm_sizes_match_jax(m, n, dtype):
    _check_trsm_trmm(m, n, "L", "L", "N", "N", np.dtype(dtype))


@pytest.mark.parametrize("dtype", ["float32", "complex128"])
@pytest.mark.parametrize("trans", ["N", "C"])
def test_trsm_residual_f32_route(trans, dtype):
    """op(A) X = alpha B holds within the JAX test's bound on the route the
    dtype takes (f32: the tile inverse and a GEMM; complex128:
    solve_triangular), on the left and on the right."""
    m, n = 130, 70
    for side in ("L", "R"):
        na = m if side == "L" else n
        a = _triangular(na, dtype, True, False, 3)
        b = _general((m, n), dtype, 4)
        x = _call(dlaf_tpu_torch.trsm, a, b, side=side, uplo="L", trans=trans, alpha=1.5, nb=64)
        at = np.tril(a)
        opa = at if trans == "N" else at.conj().T
        lhs = opa @ x if side == "L" else x @ opa
        assert _norm(lhs - 1.5 * b) <= tol(dtype, max(m, n), 100)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("trans", ["N", "C"])
@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("n,k", [(64, 32), (130, 70), (7, 130)])
def test_herk_matches_jax(n, k, uplo, trans, dtype):
    shape = (n, k) if trans == "N" else (k, n)
    a = _general(shape, dtype, 3)
    c0 = _hermitian(n, dtype, 4)
    kw = dict(uplo=uplo, trans=trans, alpha=0.5, beta=2.0)
    got = _call(dlaf_tpu_torch.herk, a, c0, **kw)
    want = _jax(dlaf_tpu.herk, a, c0, **kw)
    tri, other = (np.tril, np.triu) if uplo == "L" else (np.triu, np.tril)
    k_other = 1 if uplo == "L" else -1
    assert _norm(tri(got) - tri(want)) <= tol(dtype, max(n, k), 100) * max(1.0, _norm(want))
    # the other triangle keeps C's, bit for bit (as in the JAX test)
    np.testing.assert_array_equal(other(got, k_other), other(c0, k_other))


@pytest.mark.parametrize("mode", ["kernel", "torch"])
def test_herk_upper_c_k2_route(mode, monkeypatch):
    """herk U/C with alpha -1 and beta 1 in f32 takes K2's wrapper (its plain
    version on the CPU) under potrf_trailing_kernel="kernel", and addmm_
    under "torch"; both give JAX's result."""
    calls = []

    def spy(*args, **kw):
        calls.append(1)
        return ksub_matmul(*args, **kw)

    monkeypatch.setattr(blocked, "ksub_matmul", spy)
    n, k = 300, 200
    a = _general((k, n), "float32", 5)
    c0 = _hermitian(n, "float32", 6)
    kw = dict(uplo="U", trans="C", alpha=-1.0, beta=1.0)
    dlaf_tpu_torch.set_tune_parameters(potrf_trailing_kernel=mode)
    try:
        got = _call(dlaf_tpu_torch.herk, a, c0, **kw)
    finally:
        dlaf_tpu_torch.reset_tune_parameters()
    want = _jax(dlaf_tpu.herk, a, c0, **kw)
    assert _norm(np.triu(got) - np.triu(want)) <= tol("float32", n, 100) * _norm(want)
    assert bool(calls) == (mode == "kernel")


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
@pytest.mark.parametrize("trans", ["N", "C"])
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_her2k_matches_jax(uplo, trans, dtype):
    n, k = 130, 70
    shape = (n, k) if trans == "N" else (k, n)
    a = _general(shape, dtype, 7)
    b = _general(shape, dtype, 8)
    c0 = _hermitian(n, dtype, 9)
    alpha = 0.5 - 0.25j if np.dtype(dtype).kind == "c" else 0.5
    kw = dict(lower=(uplo == "L"), trans=trans, alpha=alpha, beta=2.0, nb=64)
    ct = torch.from_numpy(c0.copy())
    got = blocked.her2k(ct, torch.from_numpy(a), torch.from_numpy(b), **kw).numpy()
    want = np.asarray(jblocked.her2k(jnp.asarray(c0), jnp.asarray(a), jnp.asarray(b), **kw))
    assert _norm(got - want) <= tol(dtype, n, 100) * _norm(want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("side", ["L", "R"])
@pytest.mark.parametrize("n,m", [(64, 32), (130, 70)])
def test_hemm_matches_jax(n, m, side, uplo, dtype):
    a = _hermitian(n, dtype, 5)
    poison = np.full_like(a, 42.0)
    stored = np.tril(a) + np.triu(poison, 1) if uplo == "L" else np.triu(a) + np.tril(poison, -1)
    bshape = (n, m) if side == "L" else (m, n)
    b = _general(bshape, dtype, 6)
    c0 = _general(bshape, dtype, 8)
    kw = dict(side=side, uplo=uplo, alpha=0.5, beta=-1.0)
    got = _call(dlaf_tpu_torch.hemm, stored, b, c0, **kw)
    want = _jax(dlaf_tpu.hemm, stored, b, c0, **kw)
    assert _norm(got - want) <= tol(dtype, max(n, m), 100) * max(1.0, _norm(want))
    # without C: alpha A B
    got = _call(dlaf_tpu_torch.hemm, stored, b, None, side=side, uplo=uplo, alpha=0.5)
    ref = 0.5 * (a @ b if side == "L" else b @ a)
    assert _norm(got - ref) <= tol(dtype, max(n, m), 100) * max(1.0, _norm(ref))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("transb", ["N", "T", "C"])
@pytest.mark.parametrize("transa", ["N", "T", "C"])
def test_gemm_matches_jax(transa, transb, dtype):
    m, n, k = 40, 30, 50
    a = _general((m, k) if transa == "N" else (k, m), dtype, 0)
    b = _general((k, n) if transb == "N" else (n, k), dtype, 1)
    c0 = _general((m, n), dtype, 2)
    kw = dict(transa=transa, transb=transb, alpha=2.0, beta=-0.5)
    got = _call(dlaf_tpu_torch.gemm, a, b, c0, **kw)
    want = _jax(dlaf_tpu.gemm, a, b, c0, **kw)
    assert _norm(got - want) <= tol(dtype, k, 100) * max(1.0, _norm(want))
    got = _call(dlaf_tpu_torch.gemm, a, b, transa=transa, transb=transb, alpha=2.0)
    want = _jax(dlaf_tpu.gemm, a, b, transa=transa, transb=transb, alpha=2.0)
    assert _norm(got - want) <= tol(dtype, k, 100) * max(1.0, _norm(want))


@pytest.mark.parametrize("backend", [None, "torch"])
@pytest.mark.parametrize("dtype", ["float32", "float64", "complex64"])
@pytest.mark.parametrize("left", [True, False])
@pytest.mark.parametrize("trans", ["N", "T", "C"])
def test_trsm_leaf_routes(trans, left, dtype, backend):
    """trsm_leaf on the tile-inverse route (f32, by default) and on
    solve_triangular (other dtypes, or forced), lower and upper, unit and
    not, against numpy's solve of the same triangle."""
    nb, k = 64, 48
    leaf.set_leaf_backend(backend)
    try:
        for lower in (True, False):
            for unit in (False, True):
                a = _triangular(nb, dtype, lower, unit, 11)
                if unit:       # the diagonal is not read
                    np.fill_diagonal(a, 5.0)
                b = _general((nb, k) if left else (k, nb), dtype, 12)
                got = _call(leaf.trsm_leaf, a, b, left=left, lower=lower, trans=trans,
                            unit=unit)
                at = np.tril(a) if lower else np.triu(a)
                if unit:
                    np.fill_diagonal(at, 1.0)
                opa = {"N": at, "T": at.T, "C": at.conj().T}[trans]
                lhs = opa @ got if left else got @ opa
                assert _norm(lhs - b) <= tol(dtype, nb, 100)
    finally:
        leaf.set_leaf_backend(None)


def test_trsm_leaf_route_choice(monkeypatch):
    """f32 goes through trsm_tile unless the plain route is forced; f64
    never does."""
    calls = []
    real = leaf.trsm_tile

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(leaf, "trsm_tile", spy)
    for dtype, backend, want in (("float32", None, 1), ("float32", "torch", 0),
                                 ("float64", None, 0)):
        calls.clear()
        leaf.set_leaf_backend(backend)
        try:
            a = torch.from_numpy(_triangular(16, dtype, True, False, 1))
            leaf.trsm_leaf(a, torch.ones(16, 3, dtype=a.dtype), left=True, lower=True,
                           trans="N", unit=False)
        finally:
            leaf.set_leaf_backend(None)
        assert len(calls) == want, (dtype, backend)


def test_trsm_refuses_bf16():
    a = torch.eye(64, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        dlaf_tpu_torch.trsm(a, torch.ones(64, 8, dtype=torch.bfloat16), nb=64)


def test_blas_rejects_bad_input():
    with pytest.raises(ValueError, match="uplo"):
        dlaf_tpu_torch.trsm(torch.eye(4), torch.ones(4, 2), uplo="X")
    with pytest.raises(ValueError, match="square"):
        dlaf_tpu_torch.trmm(torch.zeros(4, 3), torch.ones(4, 2))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("uplo", ["G", "L", "U"])
def test_max_norm_local_matches_jax(uplo, dtype):
    a = _general((48, 40), dtype, 0)
    got = float(_call(max_norm_local, a, uplo=uplo))
    want = float(jnorm.max_norm_local(jnp.asarray(a), uplo))
    # |z| may round differently in the last place between the two libraries
    assert abs(got - want) <= tol(dtype, 1, 1.0) * max(1.0, want)
    assert float(max_norm_local(torch.zeros(0, 3))) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "complex128"])
@pytest.mark.parametrize("axis", [0, 1])
def test_permute_local_matches_jax(axis, dtype):
    a = _general((32, 24), dtype, 1)
    perm = np.random.default_rng(0).permutation(a.shape[axis])
    got = _call(permute_local, a, perm=torch.from_numpy(perm), axis=axis)
    want = np.asarray(jperm.permute_local(jnp.asarray(a), jnp.asarray(perm), axis=axis))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(permute_local(torch.from_numpy(a), list(perm), axis).numpy(),
                                  want)


@pytest.mark.parametrize("lower", [True, False])
def test_hermitian_from_tri_blocks(lower):
    """The in-place symmetrization (hegst's first step) equals
    symmetrize_tri past its first 4096-row block."""
    from dlaf_tpu_torch.ops.core import hermitian_from_tri_, symmetrize_tri
    a = torch.from_numpy(_general((4200, 4200), "complex64", 3))
    want = symmetrize_tri(a, lower)
    assert torch.equal(hermitian_from_tri_(a.clone(), lower), want)


def _recursions():
    """Each recursion of ops/blocked.py on a fresh working buffer: (name,
    call that runs it and returns the buffer)."""
    rng = np.random.default_rng(11)
    n, nb = 96, 32
    spd = torch.from_numpy(rng.standard_normal((n, n)))
    spd = spd @ spd.T + n * torch.eye(n, dtype=spd.dtype)
    tri = torch.tril(torch.from_numpy(rng.standard_normal((n, n)))) / n + 2 * torch.eye(n)
    b = torch.from_numpy(rng.standard_normal((n, 40)))
    kw = dict(lower=True, trans="N", unit=False, nb=nb)
    return {
        "potrf_lower": lambda: blocked.potrf_lower(spd.clone(), nb),
        "potrf_upper": lambda: blocked.potrf_upper(spd.clone(), nb),
        "trsm_left": lambda: blocked.trsm(b.clone(), tri, side="L", **kw),
        "trsm_right": lambda: blocked.trsm(b.T.clone(), tri, side="R", **kw),
        "trmm_left": lambda: blocked.trmm(b.clone(), tri, side="L", **kw),
        "herk": lambda: blocked.herk(spd.clone(), b, lower=True, trans="N", nb=nb),
        "her2k": lambda: blocked.her2k(spd.clone(), b, b, lower=True, trans="N", nb=nb),
    }


@pytest.mark.parametrize("name", list(_recursions()))
def test_blocked_recursion_frees_its_buffers(name):
    """A blocked recursion leaves no reference cycle behind: its working
    buffer is freed as soon as the caller drops it, with the cyclic
    garbage collector off (a full-size buffer on the card must not wait
    for the next collection)."""
    import gc
    import weakref

    call = _recursions()[name]
    gc.collect()
    gc.disable()
    try:
        ref = weakref.ref(call())
        assert ref() is None, f"{name}: its buffer outlives the call"
    finally:
        gc.enable()
