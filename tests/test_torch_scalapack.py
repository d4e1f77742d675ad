"""The port's ScaLAPACK-style API against the JAX package's.

Mirrors tests/test_api_layers.py and test_infra.py's ``c_entry`` case: the
grid registry and the descriptor, the ScaLAPACK local layouts (bit-equal
to JAX's on (23, 17) over 2x3), and the typed entries on the same seeded
numpy inputs: ``dlaf_pdpotrf`` L/U (n = 40, nb = 8; the factor to JAX's
and to A within 1e-10, the other triangle bit-equal to the input) and
``dlaf_pspotrf``, ``dlaf_pdsyevd`` (n = 48, lower and upper storage),
``dlaf_pdsygvd`` plain and ``_factorized``, ``dlaf_pzheevd`` /
``dlaf_pzhegvd`` and ``dlaf_pchegvd``, tile-aligned sub-matrix offsets of
``dlaf_pdpotrf`` and ``dlaf_pdsygvd``: eigenvalues entry by entry to JAX's
within the JAX test's ``tol`` times max|w|, eigenvectors by residual and
orthogonality (the JAX test's atol). Each case runs on the 1x1 grid in
this process and on 2x2 and 1x4 grids of four gloo ranks in one spawn
(``spawn_grid``, CPU), while the JAX references run here. Then
``c_entry.c_ppotrf``'s info on a non-SPD sub-block (diagonal read at
(ia - 1 + t, ja - 1 + t)), equal to the JAX package's.
"""
import concurrent.futures
import functools

import jax
import numpy as np
import pytest
import torch

import dlaf_tpu
from dlaf_tpu.api import scalapack as jsl
from dlaf_tpu.matrix import generators as jgen
from dlaf_tpu_torch.api import scalapack as sl
from dlaf_tpu_torch.comm.launch import spawn_grid
from dlaf_tpu_torch.comm.mesh import Grid
from dlaf_tpu_torch.native import c_entry

import torch_dist_ranks as ranks
from conftest import tol

GRIDS = [(1, 1), (2, 2), (1, 4)]


def _spd(seed, n, dtype):
    return np.asarray(jgen.random_hermitian_positive_definite(jax.random.PRNGKey(seed), n,
                                                              dtype))


def _herm(seed, n, dtype):
    return np.asarray(jgen.random_hermitian(jax.random.PRNGKey(seed), n, dtype))


def _desc9(m, nb):
    """A ScaLAPACK desc[9] of an (m, m) matrix in (nb, nb) blocks (both
    packages read it)."""
    return [1, 0, m, m, nb, nb, 0, 0, m]


def _inputs():
    """{name: (entry, args, kw)} with args = (uplo, n, arrays..., ia, ja, desc)."""
    n = 40
    d40 = _desc9(n, 8)
    a40 = _spd(0, n, np.float64)
    d48 = _desc9(48, 16)
    h = _herm(1, 48, np.float64)
    hu = np.triu(h) + np.tril(np.full((48, 48), 9.0), -1)    # U storage, poison below
    b = _spd(4, 48, np.float64)
    bl = np.linalg.cholesky(b)
    hz, bz = _herm(3, 48, np.complex128), _spd(4, 48, np.complex128)
    rng = np.random.default_rng(5)
    full = rng.standard_normal((64, 64))
    full[16:48, 16:48] = np.eye(32) * 32 + 0.1 * np.ones((32, 32))
    d64 = _desc9(64, 8)
    rng = np.random.default_rng(6)
    fa, fb = rng.standard_normal((64, 64)), rng.standard_normal((64, 64))
    fa[16:48, 32:64] = _herm(7, 32, np.float64)
    fb[0:32, 0:32] = _spd(8, 32, np.float64)
    d64b = _desc9(64, 16)
    return {
        "pdpotrf-L": ("dlaf_pdpotrf", ("L", n, a40, 1, 1, d40), {}),
        "pdpotrf-U": ("dlaf_pdpotrf", ("U", n, a40, 1, 1, d40), {}),
        "pspotrf-L": ("dlaf_pspotrf", ("L", n, a40.astype(np.float32), 1, 1, d40), {}),
        "pdsyevd-L": ("dlaf_pdsyevd", ("L", 48, h, 1, 1, d48), {}),
        "pdsyevd-U": ("dlaf_pdsyevd", ("U", 48, hu, 1, 1, d48), {}),
        "pdsygvd": ("dlaf_pdsygvd", ("L", 48, h, b, 1, 1, d48), {}),
        "pdsygvd-factorized": ("dlaf_pdsygvd_factorized", ("L", 48, h, bl, 1, 1, d48), {}),
        "pzheevd": ("dlaf_pzheevd", ("L", 48, hz, 1, 1, d48), {}),
        "pzhegvd": ("dlaf_pzhegvd", ("L", 48, hz, bz, 1, 1, d48), {}),
        "pchegvd": ("dlaf_pchegvd", ("L", 48, hz.astype(np.complex64), bz.astype(np.complex64),
                                     1, 1, d48), {}),
        "pdpotrf-sub": ("dlaf_pdpotrf", ("L", 32, full, 17, 17, d64), {}),
        "pdsygvd-sub": ("dlaf_pdsygvd", ("L", 32, fa, fb, 17, 33, d64b), dict(ib=1, jb=1)),
    }


INPUTS = _inputs()
CASES = [(gs, name) for gs in GRIDS for name in INPUTS]
IDS = [f"{gs[0]}x{gs[1]}-{name}" for gs, name in CASES]


def _port_cases(gs):
    return [(name, gs, entry, args, kw) for name, (entry, args, kw) in INPUTS.items()]


def _run_port():
    """{(grid, name): result}: 1x1 here, 2x2 and 1x4 on four spawned ranks
    (every rank's result, which must agree)."""
    out = {}
    for name, r in ranks.scalapack_cases(_port_cases((1, 1)), Grid((1, 1)),
                                          torch.device("cpu")).items():
        out[((1, 1), name)] = r
    cases = _port_cases((2, 2)) + [(f"1x4:{n}", (1, 4), e, a, k)
                                   for n, _, e, a, k in _port_cases((1, 4))]
    res = spawn_grid(functools.partial(ranks.scalapack_cases, cases), (2, 2), backend="gloo",
                     device="cpu", timeout=600)
    for key in res[0]:
        gs, name = ((1, 4), key[4:]) if key.startswith("1x4:") else ((2, 2), key)
        out[(gs, name)] = [r[key] for r in res]
    return out


def _jax(name):
    entry, args, kw = INPUTS[name]
    gs = (2, 2) if "potrf" in name else (1, 1)
    ctx = jsl.dlaf_create_grid(*gs)
    dlaf_tpu.set_tune_parameters(eigensolver_min_band=8, default_block_size=16)
    try:
        uplo, n, rest = args[0], args[1], args[2:]
        return getattr(jsl, entry)(uplo, n, *rest, ctx=ctx, **kw)
    finally:
        dlaf_tpu.tune.reset_tune_parameters()
        jsl.dlaf_free_grid(ctx)


@pytest.fixture(scope="module")
def results():
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(_run_port)
        jax_refs = {name: _jax(name) for name in INPUTS}
        return port.result(), jax_refs


def _check_potrf(name, got, want):
    _, args, _ = INPUTS[name]
    uplo, n, a, ia = args[0], args[1], args[2], args[3]
    i0 = ia - 1
    sub = slice(i0, i0 + n)
    tri = np.tril if uplo == "L" else np.triu
    f, fw = tri(got[sub, sub]), tri(want[sub, sub])
    atol = 1e-10 if a.dtype == np.float64 else tol(np.float32, n) * np.abs(a).max()
    ref = a[sub, sub].astype(np.float64)
    ff = f.astype(np.float64)
    np.testing.assert_allclose(ff @ ff.T if uplo == "L" else ff.T @ ff, ref, atol=atol)
    np.testing.assert_allclose(f, fw, atol=atol)
    keep = np.ones(a.shape, bool)
    keep[sub, sub] = tri(np.ones((n, n), bool)) == 0
    np.testing.assert_array_equal(got[keep], a[keep])     # untouched entries bit-equal


def _check_eig(name, got, want):
    entry, args, _ = INPUTS[name]
    w, z = got
    ww = want[0]
    n = args[1]
    assert w.dtype.kind == "f" and w.shape == (n,)
    dtype = args[2].dtype
    scale = max(np.abs(ww).max(), 1.0)
    np.testing.assert_allclose(w, ww, rtol=0, atol=tol(dtype, n) * scale)
    atol = 1e-8 if np.dtype(dtype).itemsize >= 8 and dtype != np.complex64 else \
        tol(dtype, n, 100) * scale
    if "gvd" in entry:
        i0, j0 = args[4] - 1, args[5] - 1
        a = args[2][i0:i0 + n, j0:j0 + n]
        ib, jb = INPUTS[name][2].get("ib", args[4]) - 1, INPUTS[name][2].get("jb", args[5]) - 1
        b = args[3][ib:ib + n, jb:jb + n]
        if "factorized" in entry:
            b = b @ b.conj().T
        np.testing.assert_allclose(a @ z, b @ z * w[None, :], atol=atol)
        np.testing.assert_allclose(z.conj().T @ b @ z, np.eye(n), atol=atol)
    else:
        a = args[2]
        if args[0] == "U":
            a = np.triu(a) + np.triu(a, 1).conj().T
        np.testing.assert_allclose(a @ z, z * w[None, :], atol=atol)
        np.testing.assert_allclose(z.conj().T @ z, np.eye(n), atol=atol)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_entry_matches_jax(results, case):
    port, jax_refs = results
    gs, name = case
    got = port[(gs, name)]
    if gs != (1, 1):
        for other in got[1:]:        # every rank gets the same whole result
            for x, y in zip(other if isinstance(other, tuple) else (other,),
                            got[0] if isinstance(got[0], tuple) else (got[0],)):
                np.testing.assert_array_equal(x, y)
        got = got[0]
    if "potrf" in name:
        _check_potrf(name, got, jax_refs[name])
    else:
        _check_eig(name, got, jax_refs[name])


def test_grid_registry():
    ctx = sl.dlaf_create_grid(1, 1)
    ctx2 = sl.dlaf_create_grid(1, 1, "C")
    assert ctx != ctx2
    assert sl.dlaf_get_grid(ctx).grid_size == (1, 1)
    assert sl.dlaf_get_grid(ctx2).order == "C"
    sl.dlaf_free_grid(ctx)
    with pytest.raises(KeyError):
        sl.dlaf_get_grid(ctx)
    sl.dlaf_free_all_grids()
    with pytest.raises(KeyError):
        sl.dlaf_get_grid(ctx2)
    # one process cannot hold a 2x2 grid: one process per rank
    with pytest.raises(ValueError):
        sl.dlaf_create_grid(2, 2)
    with pytest.raises(ValueError):
        sl.dlaf_create_grid(1, 1, "X")


def test_descriptor_from_scalapack():
    desc9 = [1, 0, 100, 80, 16, 16, 0, 0, 50]
    d = sl.DLAF_descriptor.from_scalapack(desc9)
    assert _fields(d) == _fields(jsl.DLAF_descriptor.from_scalapack(desc9))
    assert (d.m, d.n, d.mb, d.nb, d.ld) == (100, 80, 16, 16, 50)


def _fields(d):
    """The descriptor's fields in order."""
    return (d.m, d.n, d.mb, d.nb, d.isrc, d.jsrc, d.i, d.j, d.ld)


@pytest.mark.parametrize("src", [(0, 0), (1, 2)])
def test_scalapack_locals_bit_equal(src):
    a = np.random.default_rng(9).standard_normal((23, 17))
    desc = sl.DLAF_descriptor(m=23, n=17, mb=4, nb=3, isrc=src[0], jsrc=src[1])
    jdesc = jsl.DLAF_descriptor(m=23, n=17, mb=4, nb=3, isrc=src[0], jsrc=src[1])
    got, want = sl.to_scalapack_locals(a, desc, (2, 3)), jsl.to_scalapack_locals(a, jdesc, (2, 3))
    for p in range(2):
        for q in range(3):
            assert got[p][q].flags.f_contiguous
            np.testing.assert_array_equal(got[p][q], want[p][q])
    back = sl.from_scalapack_locals(got, desc, (2, 3))
    np.testing.assert_array_equal(back, a)
    np.testing.assert_array_equal(back, jsl.from_scalapack_locals(want, jdesc, (2, 3)))


def test_entries_refuse_missing_card():
    """Without a device argument the entries run on the card, and raise
    where there is none (no fallback to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ctx = sl.dlaf_create_grid(1, 1)
    try:
        a = np.eye(8)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sl.dlaf_pdpotrf("L", 8, a, 1, 1, sl.DLAF_descriptor(8, 8, 4, 4), ctx)
    finally:
        sl.dlaf_free_grid(ctx)


def test_unaligned_offset_raises():
    ctx = sl.dlaf_create_grid(1, 1)
    try:
        with pytest.raises(ValueError, match="tile-aligned"):
            sl.dlaf_pdpotrf("L", 8, np.eye(16), 2, 1, sl.DLAF_descriptor(16, 16, 4, 4), ctx,
                            device="cpu")
    finally:
        sl.dlaf_free_grid(ctx)


@pytest.mark.parametrize("dt", ["float32", "float64"])
def test_c_ppotrf_submatrix_info(monkeypatch, dt):
    """c_ppotrf's info reads the sub-matrix diagonal (ia-1+t, ja-1+t): a
    non-SPD block off the main diagonal gives info > 0, as in the JAX
    package (tests/test_infra.py:166), and the same info."""
    # imported here: at import, the JAX module sets the CPU device count
    # unless the backend is already up (as in tests/test_infra.py)
    from dlaf_tpu.native import c_entry as jc_entry

    monkeypatch.setenv(c_entry.DEVICE_ENV, "cpu")
    m, nb, n = 8, 4, 4

    def buffer():
        a = np.zeros((m, m), dtype=dt, order="F")
        np.fill_diagonal(a, 5.0)                      # finite main diagonal
        a[4:8, 0:4] = -np.eye(4, dtype=dt)            # non-SPD target block
        return a

    infos = []
    for mod in (c_entry, jc_entry):
        a = buffer()
        ctx = mod.c_create_grid(1, 1)
        try:
            infos.append(mod.c_ppotrf("L", n, a.ctypes.data, 5, 1, [1, ctx, m, m, nb, nb, 0, 0, m],
                                      ctx, dt))
        finally:
            mod.c_free_grid(ctx)
        np.testing.assert_array_equal(a, buffer())    # a failed factor is not written back
    assert infos[0] > 0 and infos[0] == infos[1], infos


def test_c_entry_device_variable(monkeypatch):
    monkeypatch.setenv(c_entry.DEVICE_ENV, "tpu")
    with pytest.raises(ValueError):
        c_entry.device()
    monkeypatch.delenv(c_entry.DEVICE_ENV)
    assert c_entry.device() == "cuda"
