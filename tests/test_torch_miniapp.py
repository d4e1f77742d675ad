"""The port's Cholesky and eigensolver miniapps on the CPU: --check passes
and the CSVData-2 row has the JAX miniapp's fields."""
import numpy as np
import pytest

import dlaf_tpu
from dlaf_tpu.miniapps import miniapp_cholesky as jax_miniapp
from dlaf_tpu_torch.miniapps import miniapp_cholesky, miniapp_eigensolver


def _csv(out):
    rows = [l for l in out.splitlines() if l.startswith("CSVData-2")]
    assert len(rows) == 1
    return [f.strip() for f in rows[0].split(",")]


@pytest.mark.parametrize("typ", ["s", "d", "c"])
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_miniapp_cholesky_cpu(typ, uplo, capsys):
    miniapp_cholesky.main(["-n", "96", "-b", "32", "--check", "--nruns", "1",
                           "--type", typ, "--uplo", uplo, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "check: PASSED" in out
    row = _csv(out)
    assert row[0] == "CSVData-2" and row[4:] == [typ, uplo, "96", "32", "1", "1", "1", "cpu"]


def test_miniapp_csv_fields_match_jax(capsys):
    argv = ["-n", "64", "-b", "32", "--nruns", "1", "--nwarmups", "0"]
    dlaf_tpu.set_tune_parameters(default_block_size=16)
    try:
        jax_miniapp.main(argv)
    finally:
        dlaf_tpu.tune.reset_tune_parameters()
    want = _csv(capsys.readouterr().out)
    miniapp_cholesky.main(argv + ["--device", "cpu"])
    got = _csv(capsys.readouterr().out)
    assert len(got) == len(want) == 12
    # run index, type, uplo, sizes, grid and backend agree; time and rate differ
    same = [0, 1, 4, 5, 6, 7, 8, 9, 10, 11]
    assert [got[i] for i in same] == [want[i] for i in same]


def test_miniapp_trace(tmp_path, capsys):
    miniapp_cholesky.main(["-n", "64", "-b", "32", "--nruns", "1", "--nwarmups", "0",
                           "--device", "cpu", "--trace", str(tmp_path)])
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert "trace:" in capsys.readouterr().out


def test_miniapp_grid_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        miniapp_cholesky.main(["-n", "64", "--grid-rows", "2", "--grid-cols", "2",
                               "--device", "cpu"])


@pytest.mark.parametrize("typ", ["s", "d", "c"])
def test_miniapp_eigensolver_cpu(typ, capsys):
    miniapp_eigensolver.main(["-n", "64", "--band-size", "16", "--check", "--nruns", "1",
                              "--nwarmups", "0", "--type", typ, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "check: PASSED" in out
    row = _csv(out)
    assert row[4:] == [typ, "L", "64", "256", "1", "1", "1", "cpu"]


def test_miniapp_eigensolver_check_gates():
    """The miniapp's gates pass a sound decomposition and reject one
    eigenvector column that is off by 1e-3 (as the JAX miniapp's check)."""
    import torch
    a = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 64)))
    a = (a + a.T) / 2
    w, v = torch.linalg.eigh(a)
    assert miniapp_eigensolver.check_eigh(a, w, v, torch.float64)[0]
    v[:, 3] *= 1 + 1e-3
    assert not miniapp_eigensolver.check_eigh(a, w, v, torch.float64)[0]


def test_miniapp_eigensolver_grid_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        miniapp_eigensolver.main(["-n", "64", "--grid-rows", "2", "--device", "cpu"])
