"""The port's five stage miniapps and kernel_runner on the CPU.

The stage miniapps (reduction to band, band to tridiagonal, tridiagonal
solver and the two back-transformations) run with --check in s and d, and
in z where the stage takes complex input (the tridiagonal solver's matrix
is real), at the JAX miniapp tests' sizes (tests/test_miniapps.py); each
refuses a grid larger than 1x1 outside torchrun (its distributed branch
runs in tests/test_torch_dist_eigensolver.py), and the CSVData-2 row has
the JAX miniapp's fields. kernel_runner's
kernel table runs on the same numpy tiles as the JAX functions it stands
for: potrf_leaf, trsm_leaf, mm and set_tri on the CPU, and the Pallas
ksub_matmul in interpret mode, each held to tol(dtype, nb, 100) relative to
the result's size (laset and lacpy exactly).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dlaf_tpu
from dlaf_tpu.miniapps import miniapp_reduction_to_band as jax_red2band
from dlaf_tpu.ops import leaf as jax_leaf
from dlaf_tpu.ops.core import mm as jax_mm
from dlaf_tpu.ops.core import set_tri as jax_set_tri
from dlaf_tpu.ops.pallas.trailing import ksub_matmul as jax_ksub_matmul
from dlaf_tpu_torch.miniapps import (kernel_runner, miniapp_band_to_tridiag,
                                     miniapp_bt_band_to_tridiag, miniapp_bt_reduction_to_band,
                                     miniapp_reduction_to_band, miniapp_tridiag_solver)

from conftest import tol

MINIAPPS = {
    "reduction_to_band": (miniapp_reduction_to_band, ["-n", "64", "--band-size", "16"], "sdz"),
    "band_to_tridiag": (miniapp_band_to_tridiag, ["-n", "64", "--band-size", "8"], "sdz"),
    "tridiag_solver": (miniapp_tridiag_solver, ["-n", "70"], "sd"),
    "bt_band_to_tridiag": (miniapp_bt_band_to_tridiag, ["-n", "64", "--band-size", "8"], "sdz"),
    "bt_reduction_to_band": (miniapp_bt_reduction_to_band, ["-n", "64", "--band-size", "16"],
                             "sdz"),
}
CHECK_CASES = [(name, typ) for name, (_, _, types) in MINIAPPS.items() for typ in types]


def _csv(out):
    rows = [l for l in out.splitlines() if l.startswith("CSVData-2")]
    assert len(rows) == 1
    return [f.strip() for f in rows[0].split(",")]


@pytest.mark.parametrize("name,typ", CHECK_CASES, ids=[f"{n}-{t}" for n, t in CHECK_CASES])
def test_stage_miniapp_check(name, typ, capsys):
    mod, argv, _ = MINIAPPS[name]
    mod.main(argv + ["--check", "--nruns", "1", "--nwarmups", "0", "--type", typ,
                     "--device", "cpu"])
    out = capsys.readouterr().out
    assert "check: PASSED" in out
    row = _csv(out)
    assert row[4] == typ and row[8:] == ["1", "1", "1", "cpu"]


@pytest.mark.parametrize("name", list(MINIAPPS))
def test_stage_miniapp_refuses_grid(name):
    mod, argv, _ = MINIAPPS[name]
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        mod.main(argv + ["--grid-rows", "2", "--device", "cpu"])


def test_stage_miniapp_check_rejects_planted_fault(monkeypatch, capsys):
    """The band-to-tridiagonal check fails a diagonal moved by 0.1 (the
    bound is 500 n eps32 = 3.8e-3 relative at n = 64)."""
    real = miniapp_band_to_tridiag.band_to_tridiag_auto

    def bad(band, b):
        d, e, vs, taus = real(band, b)
        d = d.clone()
        d[5] += 0.1
        return d, e, vs, taus

    monkeypatch.setattr(miniapp_band_to_tridiag, "band_to_tridiag_auto", bad)
    with pytest.raises(SystemExit):
        miniapp_band_to_tridiag.main(["-n", "64", "--band-size", "8", "--check", "--nruns", "1",
                                      "--nwarmups", "0", "--device", "cpu"])
    assert "check: FAILED" in capsys.readouterr().out


def test_csv_fields_match_jax(capsys):
    argv = ["-n", "64", "--band-size", "16", "--nruns", "1", "--nwarmups", "0"]
    dlaf_tpu.set_tune_parameters(eigensolver_min_band=8, default_block_size=16)
    try:
        jax_red2band.main(argv)
    finally:
        dlaf_tpu.tune.reset_tune_parameters()
    want = _csv(capsys.readouterr().out)
    miniapp_reduction_to_band.main(argv + ["--device", "cpu"])
    got = _csv(capsys.readouterr().out)
    assert len(got) == len(want) == 12
    # run index, type, uplo, sizes, grid and backend agree; time and rate differ
    same = [0, 1, 4, 5, 6, 7, 8, 9, 10, 11]
    assert [got[i] for i in same] == [want[i] for i in same]


NB, COUNT = 64, 4


def _tiles(dtype):
    rng = np.random.default_rng(7)
    return {"tiles": rng.standard_normal((COUNT, NB, NB)).astype(dtype),
            "xk": rng.standard_normal((4 * NB, NB)).astype(dtype),
            "yk": rng.standard_normal((4 * NB, NB)).astype(dtype)}


def _jax_kernel(name, tiles, xk, yk):
    """JAX's functions for kernel_runner's table (dlaf_tpu/miniapps/kernel_runner.py)."""
    eye = jnp.eye(NB, dtype=tiles.dtype)[None]
    spd = jnp.einsum("bij,bkj->bik", tiles, tiles) + 4 * NB * eye
    tri = jnp.tril(tiles) + 4 * eye
    if name == "potrf":
        return jax.vmap(jax_leaf.potrf_leaf)(spd)
    if name == "trsm":
        return jax.vmap(lambda a, b: jax_leaf.trsm_leaf(a, b, left=True, lower=True, trans="N",
                                                        unit=False))(tri, tiles)
    if name == "gemm":
        return jax.vmap(jax_mm)(tiles, tiles)
    if name == "laset":
        return jnp.full_like(tiles, 0.5)
    if name == "lacpy":
        return tiles + 0.0
    if name == "add":
        return jax.vmap(lambda a, b: jax_set_tri(b, b + 0.5 * a, True))(tiles, spd)
    return jax_ksub_matmul(tiles[0], xk, yk, interpret=True)


# the Pallas ksub_matmul takes f32 only
KERNEL_CASES = [(k, t) for k in kernel_runner.KERNELS for t in ("float32", "float64")
                if (k, t) != ("ksub", "float64")]


@pytest.mark.parametrize("name,dtype", KERNEL_CASES, ids=[f"{k}-{t}" for k, t in KERNEL_CASES])
def test_kernel_runner_matches_jax(name, dtype):
    arrays = _tiles(np.dtype(dtype))
    inputs = {k: torch.from_numpy(v) for k, v in arrays.items()}
    fn, args, flops = kernel_runner.kernels(NB, COUNT, inputs["tiles"].dtype,
                                            torch.device("cpu"), inputs)[name]
    got = fn(*args).numpy()
    want = np.asarray(_jax_kernel(name, *(jnp.asarray(v) for v in arrays.values())))
    assert got.shape == want.shape
    if name in ("laset", "lacpy"):
        np.testing.assert_array_equal(got, want)
        assert flops == 0
        return
    if name == "potrf":
        # JAX's leaf zeroes the other triangle too; both are the lower factor
        got, want = np.tril(got), np.tril(want)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1.0)
    assert err <= tol(np.dtype(dtype), NB, 100), (name, dtype, err)
    per_tile = {"potrf": NB**3 / 3, "trsm": NB**3, "gemm": 2 * NB**3, "add": 0,
                "ksub": 2 * NB * NB * 4 * NB / COUNT}
    assert flops == per_tile[name]


@pytest.mark.parametrize("name", kernel_runner.KERNELS)
def test_kernel_runner_cli(name, capsys):
    kernel_runner.main(["--kernel", name, "-b", "32", "--count", "3", "--nruns", "1",
                        "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and out[0].startswith(f"[0] {name} b=32 x3: ") and "us/tile" in out[0]
    # the plain versions run on the CPU: no kernel launch
    assert out[0].endswith("cpu (K1 launches 0, K2 launches 0)")
