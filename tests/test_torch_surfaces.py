"""The port's user surfaces against the JAX package's: init, matrix files
and printing, the rest of DistMatrix and Grid, the native host library,
miniapp_communication and the miniapps' file options.

- ``init.initialize(print_config=True)`` and ``ScopedInitializer``;
- ``matrix/io.py`` round trips across packages in both containers (.npz,
  and .h5 in the reference's layout): JAX writes and the port reads
  bit-equal, and the other way round; ``read_dist`` on 2x2;
- ``print_numpy``/``print_csv`` text equal to JAX's, of arrays and of a
  DistMatrix on 2x2 (rank 0 writes);
- ``DistMatrix.from_callback``, ``retiled``, ``sub_matrix`` and
  ``set_sub_matrix`` bit-equal to JAX's, shard by shard, on 1x1, 2x2 and
  2x3 grids, ragged sizes and ``pad_identity`` included;
- ``Grid.multihost`` on four spawned ranks with faked host names, against
  JAX's ``multihost`` layout of devices with the same process indices;
- ``native.pack_local``/``unpack_local`` against ``to_scalapack_locals``
  (the g++ library for f32/f64, the numpy loops otherwise), and
  ``band_to_tridiag_host`` against JAX's on the same band within ``tol``;
- ``miniapp_communication`` with ``--check`` on 1x1 and 2x2;
- the eigensolver, gen_eigensolver, reduction_to_band and tridiag_solver
  miniapps reading with ``--input-file --check`` the files that JAX's
  miniapps wrote (``--output-file``), and writing their own.

Grid cases run on gloo ranks spawned by ``spawn_grid`` (CPU, one spawn per
grid) in a background thread while the JAX references run here.
"""
import concurrent.futures
import contextlib
import functools
import io
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlaf_tpu.api import scalapack as jsl
from dlaf_tpu.comm.mesh import COL_AXIS as JCOL, ROW_AXIS as JROW
from dlaf_tpu.comm.mesh import Grid as JaxGrid
from dlaf_tpu.matrix import io as jio
from dlaf_tpu.matrix import printing as jprinting
from dlaf_tpu.matrix.dist_matrix import DistMatrix as JaxDistMatrix
from dlaf_tpu_torch import init, native
from dlaf_tpu_torch.comm.launch import spawn_grid
from dlaf_tpu_torch.comm.mesh import COL_AXIS, ROW_AXIS, Grid
from dlaf_tpu_torch.matrix import io as mio
from dlaf_tpu_torch.matrix import printing
from dlaf_tpu_torch.matrix.dist_matrix import DistMatrix
from dlaf_tpu_torch.ops.kernels import _build

import torch_dist_ranks as ranks
from conftest import tol

GRIDS = [(1, 1), (2, 2), (2, 3)]
CPU = torch.device("cpu")


def _rng(key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _matrix(key, shape, dtype=np.float64):
    r = _rng(key)
    x = r.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        x = x + 1j * r.standard_normal(shape)
    return x.astype(dtype)


# (key, kind, arrays, kw) of the DistMatrix cases, the same on every grid
A = _matrix("a", (85, 70))
AZ = _matrix("az", (50, 37), np.complex128)
DM_CASES = [
    ("callback", "from_callback", (A,), dict(nb=16, pad=False)),
    ("callback-pad", "from_callback", (A,), dict(nb=16, pad=True)),
    ("callback-c128-pad", "from_callback", (AZ,), dict(nb=8, pad=True)),
    ("retiled", "retiled", (A,), dict(nb=16, tile=(8, 8))),
    ("sub-12", "sub_matrix", (A,), dict(nb=16, offset=(1, 2), size=(45, 37), pad=False)),
    ("sub-12-pad", "sub_matrix", (A,), dict(nb=16, offset=(1, 2), size=(45, 37), pad=True)),
    ("sub-21-pad", "sub_matrix", (A,), dict(nb=16, offset=(2, 1), size=(37, 45), pad=True)),
    ("sub-30", "sub_matrix", (A,), dict(nb=16, offset=(3, 0), size=(37, 70), pad=False)),
    ("sub-c128", "sub_matrix", (AZ,), dict(nb=8, offset=(1, 3), size=(30, 13), pad=True)),
    ("set-12", "set_sub_matrix", (A, _matrix("s12", (45, 37))), dict(nb=16, offset=(1, 2))),
    ("set-21", "set_sub_matrix", (A, _matrix("s21", (37, 45))), dict(nb=16, offset=(2, 1))),
    ("set-c128", "set_sub_matrix", (AZ, _matrix("sz", (30, 13), np.complex128)),
     dict(nb=8, offset=(1, 3))),
]
HOSTS = {"alternate": ["a", "b", "a", "b"], "blocked": ["a", "a", "b", "b"],
         "one-host": ["a", "a", "a", "a"]}
MULTIHOST = [(f"{name}-{axis}", hosts, axis) for name, hosts in HOSTS.items()
             for axis in (ROW_AXIS, COL_AXIS)]
COMM_ARGV = ["-n", "64", "--check", "--device", "cpu", "--nruns", "2"]


def _grid_cases(gs, tmp):
    cases = list(DM_CASES)
    if gs == (2, 2):
        cases.append(("read_dist", "read_dist", (), dict(nb=8, path=str(tmp / "rd.npz"),
                                                         name="input")))
        cases.append(("print", "print", (_matrix("p", (7, 5)),), dict(nb=2)))
        cases += [(f"multihost-{key}", "multihost", (), dict(hosts=hosts, intra=axis))
                  for key, hosts, axis in MULTIHOST]
        cases.append(("communication", "communication", (),
                      dict(argv=COMM_ARGV + ["--grid-rows", "2", "--grid-cols", "2"])))
    return cases


def _run_port(tmp):
    out = {}
    for gs in GRIDS:
        cases = _grid_cases(gs, tmp)
        if gs == (1, 1):
            res = [ranks.surface_cases(cases, Grid(gs), CPU)]
        else:
            res = spawn_grid(functools.partial(ranks.surface_cases, cases), gs, backend="gloo",
                             device="cpu", timeout=600)
        out[gs] = res
    return out


def _jax_dm(gs, kind, arrays, kw):
    grid = JaxGrid(gs)
    nb = kw["nb"]

    def dm(x, pad=False):
        return JaxDistMatrix.from_global(jnp.asarray(x), nb, grid, pad_identity=pad)

    if kind == "from_callback":
        a = arrays[0]
        r = JaxDistMatrix.from_callback(lambda idx: a[idx], a.shape, nb, grid, a.dtype,
                                        pad_identity=kw["pad"])
    elif kind == "retiled":
        r = dm(arrays[0]).retiled(kw["tile"])
        return np.asarray(r.data), r.dist.tile
    elif kind == "sub_matrix":
        r = dm(arrays[0]).sub_matrix(kw["offset"], kw["size"], pad_identity=kw["pad"])
    else:
        r = dm(arrays[0]).set_sub_matrix(dm(arrays[1]), kw["offset"])
    return np.asarray(r.data), np.asarray(r.to_global())


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("surfaces")
    jio.MatrixFile(str(tmp / "rd.npz")).write(input=_matrix("rd", (37, 29)))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(_run_port, tmp)
        refs = {(gs, key): _jax_dm(gs, kind, arrays, kw)
                for gs in GRIDS for key, kind, arrays, kw in DM_CASES}
        return port.result(), refs, tmp


DM_IDS = [f"{gs[0]}x{gs[1]}-{c[0]}" for gs in GRIDS for c in DM_CASES]


@pytest.mark.parametrize("case", [(gs, c) for gs in GRIDS for c in DM_CASES], ids=DM_IDS)
def test_dist_matrix_matches_jax(results, case):
    port, refs, _ = results
    gs, (key, kind, arrays, kw) = case
    want = refs[(gs, key)]
    for r in port[gs]:
        p, q = r["coords"]
        got = r[key]
        np.testing.assert_array_equal(got["shard"], want[0][p, q])
        if kind == "from_callback":
            assert got["from_global_equal"]
        elif kind == "retiled":
            assert got["same"] and tuple(got["tile"]) == tuple(want[1])
            assert tuple(got["size"]) == arrays[0].shape
        else:
            np.testing.assert_array_equal(got["global"], want[1])
    if kind == "sub_matrix":
        (oi, oj), (m2, n2) = kw["offset"], kw["size"]
        nb = kw["nb"]
        np.testing.assert_array_equal(port[gs][0][key]["global"],
                                      arrays[0][oi * nb:oi * nb + m2, oj * nb:oj * nb + n2])
    if kind == "set_sub_matrix":
        (oi, oj), (m2, n2), nb = kw["offset"], arrays[1].shape, kw["nb"]
        want_g = arrays[0].copy()
        want_g[oi * nb:oi * nb + m2, oj * nb:oj * nb + n2] = arrays[1]
        np.testing.assert_array_equal(port[gs][0][key]["global"], want_g)


def _jax_multihost_table(hosts, axis):
    """JAX's ``Grid.multihost`` layout for devices whose process indices
    follow ``hosts`` (one device per rank), as a (P, Q) table of ranks."""
    order = list(dict.fromkeys(hosts))
    devs = [types.SimpleNamespace(rank=r, process_index=order.index(h))
            for r, h in enumerate(hosts)]

    class Layout:            # records the grid JAX would build
        def __init__(self, grid_size, devices):
            self.grid_size, self.devices = grid_size, devices

    g = JaxGrid.multihost.__func__(Layout, JROW if axis == ROW_AXIS else JCOL, devices=devs)
    P, Q = g.grid_size
    return [[g.devices[p * Q + q].rank for q in range(Q)] for p in range(P)]


@pytest.mark.parametrize("key,hosts,axis", MULTIHOST, ids=[m[0] for m in MULTIHOST])
def test_multihost_matches_jax(results, key, hosts, axis):
    port, _, _ = results
    want = _jax_multihost_table(hosts, axis)
    for r in port[(2, 2)]:
        got = r[f"multihost-{key}"]
        assert got["table"] == want
        assert tuple(got["grid_size"]) == (len(want), len(want[0]))
        p, q = got["coords"]
        assert want[p][q] == r["rank"]
        # the row-axis allreduce summed the ranks of this rank's grid column
        assert got["row_sum"] == sum(want[i][q] for i in range(len(want)))


def test_multihost_uneven_hosts_raise():
    with pytest.raises(ValueError):
        Grid.multihost("x")
    assert Grid.multihost(ROW_AXIS).grid_size == (1, 1)


def test_read_dist_and_print_on_grid(results):
    port, _, tmp = results
    a = jio.MatrixFile(str(tmp / "rd.npz")).read("input")
    jdm = JaxDistMatrix.from_global(jnp.asarray(a), 8, JaxGrid((2, 2)))
    for r in port[(2, 2)]:
        p, q = r["coords"]
        np.testing.assert_array_equal(r["read_dist"]["global"], a)
        np.testing.assert_array_equal(r["read_dist"]["shard"], np.asarray(jdm.data)[p, q])
    buf = io.StringIO()
    x = _matrix("p", (7, 5))
    jprinting.print_numpy(x, "m", file=buf)
    jprinting.print_csv(x, file=buf)
    texts = {r["rank"]: r["print"] for r in port[(2, 2)]}
    assert texts[0] == buf.getvalue()
    assert all(texts[k] == "" for k in (1, 2, 3))


def test_communication_miniapp(results):
    port, _, _ = results
    outs = {r["rank"]: r["communication"] for r in port[(2, 2)]}
    assert "check: PASSED" in outs[0] and all(outs[k] == "" for k in (1, 2, 3))
    for name in ("psum_row", "psum_col", "ring_row", "allgather_row"):
        assert f"{name}: " in outs[0]
    buf = io.StringIO()
    from dlaf_tpu_torch.miniapps import miniapp_communication
    with contextlib.redirect_stdout(buf):
        miniapp_communication.main(COMM_ARGV)
    assert "check: PASSED" in buf.getvalue()


# ---------------------------------------------------------------------------
# files and printing


IO_DATA = {"/input": _matrix("io", (8, 6)), "/evals": np.arange(5.0),
           "/evecs": _matrix("ioz", (4, 4), np.complex128),
           "/single": _matrix("io32", (3, 7)).astype(np.float32)}


@pytest.mark.parametrize("ext", [".npz", ".h5"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_matrix_file_across_packages(tmp_path, ext, writer):
    if ext == ".h5":
        pytest.importorskip("h5py")
    path = str(tmp_path / f"f{ext}")
    w, r = (jio, mio) if writer == "jax" else (mio, jio)
    data = dict(IO_DATA)
    if writer == "port":
        data["/input"] = torch.from_numpy(data["/input"])      # tensors are written too
    w.MatrixFile(path).write(**data)
    f = r.MatrixFile(path)
    for k, v in IO_DATA.items():
        got = f.read(k)
        assert got.dtype == v.dtype and got.shape == v.shape
        np.testing.assert_array_equal(got, v)
    assert set(f.read_all()) == {k.lstrip("/") for k in IO_DATA}
    f.write(**{"/evals": np.arange(3.0)})          # replaces one, keeps the others
    np.testing.assert_array_equal(w.MatrixFile(path).read("/evals"), np.arange(3.0))
    np.testing.assert_array_equal(w.MatrixFile(path).read("/input"), IO_DATA["/input"])


def test_matrix_file_dist_and_debug_dump(tmp_path):
    a = _matrix("dd", (20, 20))
    f = mio.MatrixFile(str(tmp_path / "ckpt"))
    f.write(input=DistMatrix.from_global(torch.from_numpy(a), 8, Grid((1, 1))))
    np.testing.assert_array_equal(jio.MatrixFile(str(tmp_path / "ckpt")).read("input"), a)
    dm = f.read_dist("input", 8, Grid((1, 1)), device="cpu")
    np.testing.assert_array_equal(dm.to_global().numpy(), a)
    from dlaf_tpu_torch.tune import reset_tune_parameters, set_tune_parameters
    mio.debug_dump("off", x=a)
    assert not (tmp_path / "dump").exists()
    set_tune_parameters(debug_dump_cholesky_data=True, debug_dump_path=str(tmp_path / "dump"))
    try:
        mio.debug_dump("chol", x=a)
    finally:
        reset_tune_parameters()
    np.testing.assert_array_equal(mio.MatrixFile(str(tmp_path / "dump" / "chol")).read("x"), a)


PRINT_ARRAYS = {"f64": _matrix("pr", (3, 4)), "f32": _matrix("pr32", (2, 3)).astype(np.float32),
                "c128": _matrix("prz", (2, 2), np.complex128), "vector": np.arange(5.0) / 3}


@pytest.mark.parametrize("name", list(PRINT_ARRAYS))
def test_printing_matches_jax(name):
    x = PRINT_ARRAYS[name]
    texts = []
    for mod, arg in ((jprinting, x), (printing, x), (printing, torch.from_numpy(x))):
        bufs = io.StringIO(), io.StringIO()
        mod.print_numpy(arg, "m", file=bufs[0])
        mod.print_csv(arg, file=bufs[1])
        texts.append((bufs[0].getvalue(), bufs[1].getvalue()))
    assert texts[1] == texts[0] and texts[2] == texts[0]
    ns = {"np": np}
    exec(texts[0][0], ns)
    np.testing.assert_array_equal(ns["m"].astype(x.dtype), x)


# ---------------------------------------------------------------------------
# init


def test_init_print_config(capsys, tmp_path):
    init.finalize()
    before = _build.BUILD_DIR
    try:
        init.initialize(print_config=True, device="cpu", cache_dir=str(tmp_path / "kernels"))
        out = capsys.readouterr().out
        assert "dlaf_tpu_torch configuration" in out
        assert "eigensolver_min_band" in out and "device: cpu" in out
        assert f"kernel build directory: {tmp_path / 'kernels'}" in out
        assert _build.BUILD_DIR == tmp_path / "kernels"
        init.initialize(print_config=True)          # idempotent: nothing again
        assert capsys.readouterr().out == ""
    finally:
        init.finalize()
        _build.BUILD_DIR = before
    with init.ScopedInitializer(device="cpu"):
        assert init._initialized
    assert not init._initialized
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init.initialize()
    assert init.default_backend("cpu", 4) == "gloo"


# ---------------------------------------------------------------------------
# the native host library


@pytest.mark.parametrize("kind", ["f64", "f32", "c128", "f64-fortran", "src12"])
def test_pack_unpack_match_scalapack_locals(kind):
    dtype = {"f32": np.float32, "c128": np.complex128}.get(kind, np.float64)
    a = _matrix(("pack", kind), (31, 18), dtype)
    if kind == "f64-fortran":
        a = np.asfortranarray(a)
    src = (1, 2) if kind == "src12" else (0, 0)
    desc = jsl.DLAF_descriptor(m=31, n=18, mb=4, nb=3, isrc=src[0], jsrc=src[1])
    ref = jsl.to_scalapack_locals(a, desc, (2, 3))
    back = np.zeros((31, 18), dtype)
    for p in range(2):
        for q in range(3):
            got = native.pack_local(a, 4, 3, (2, 3), (p, q), src)
            np.testing.assert_array_equal(got, ref[p][q])
            native.unpack_local(np.asfortranarray(got), 31, 18, 4, 3, (2, 3), (p, q), back, src)
    np.testing.assert_array_equal(back, a)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_band_to_tridiag_host_matches_jax(dtype):
    from dlaf_tpu.native import band_to_tridiag_host as jax_host
    n, b = 40, 4
    x = _matrix(("band", np.dtype(dtype).name), (n, n))
    x = (x + x.T) / 2
    band = np.triu(np.tril(x, b), -b).astype(dtype)
    got, want = native.band_to_tridiag_host(band, b), jax_host(band, b)
    bound = tol(dtype, n) * max(np.abs(band).max(), 1.0)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=0, atol=bound)
    # the tridiagonal keeps the band's eigenvalues
    d, e = got[0].astype(np.float64), got[1].astype(np.float64)
    t = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    np.testing.assert_allclose(np.linalg.eigvalsh(t), np.linalg.eigvalsh(band.astype(np.float64)),
                               atol=bound * 10)
    with pytest.raises(ValueError):
        native.band_to_tridiag_host(band.astype(np.complex64), b)


# ---------------------------------------------------------------------------
# the miniapps' file options, on files JAX's miniapps wrote


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


MINIAPP_FILES = {
    "eigensolver": (["-n", "64", "--band-size", "16"], ".h5", ["/input", "/evals", "/evecs"]),
    "gen_eigensolver": (["-n", "64", "--band-size", "16"], ".npz",
                        ["/input-a", "/input-b", "/evals", "/evecs"]),
    "reduction_to_band": (["-n", "64", "--band-size", "16"], ".npz", ["/input", "/band"]),
    "tridiag_solver": (["-n", "64"], ".npz", ["/tridiag"]),
}


@pytest.mark.parametrize("name", list(MINIAPP_FILES))
def test_miniapp_reads_jax_files(tmp_path, name):
    import importlib
    argv, ext, datasets = MINIAPP_FILES[name]
    if ext == ".h5":
        pytest.importorskip("h5py")
    jmod = importlib.import_module(f"dlaf_tpu.miniapps.miniapp_{name}")
    pmod = importlib.import_module(f"dlaf_tpu_torch.miniapps.miniapp_{name}")
    jfile, pfile = str(tmp_path / f"jax{ext}"), str(tmp_path / f"port{ext}")
    common = ["--nruns", "1", "--nwarmups", "0", "--type", "d"]
    if name == "tridiag_solver":
        # the JAX miniapp reads (n, 2) tridiagonals and writes none
        r = _rng("td")
        td = np.stack([r.uniform(-1, 1, 64), r.uniform(-1, 1, 64)], axis=1)
        jio.MatrixFile(jfile).write(**{"/tridiag": td})
        assert "check: PASSED" in _run(jmod.main, ["--input-file", jfile, "--check"] + common)
    else:
        out = _run(jmod.main, argv + common + ["--output-file", jfile])
        assert f"output: {jfile}" in out
    out = _run(pmod.main, ["--input-file", jfile, "--check", "--device", "cpu"] + common +
               argv[2:] + ([] if name == "tridiag_solver" else ["--output-file", pfile]))
    assert "check: PASSED" in out, out
    assert "(64, " in out                  # the size came from the file
    if name == "tridiag_solver":
        return
    jf, pf = jio.MatrixFile(jfile), mio.MatrixFile(pfile)
    for k in datasets:
        got, want = pf.read(k), jf.read(k)
        assert got.shape == want.shape, k
        if k.startswith("/input"):
            np.testing.assert_array_equal(got, want)
    if "/evals" in datasets:
        w = jf.read("/evals")
        np.testing.assert_allclose(pf.read("/evals"), w, rtol=0,
                                   atol=tol(np.float64, 64) * np.abs(w).max())
