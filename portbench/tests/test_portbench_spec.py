"""Every file of the benchmark parses and names what the harness needs, and
BENCHMARK.json agrees with the files and keeps to the benchmark's contract.

A cell file that BENCHMARK.json does not list yet (a parked cell) still has
to load and name metrics that its cells report."""
import json
import re
from pathlib import Path

import pytest

from portbench import spec

ROOT = Path(spec.ROOT).parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"][1] == "portbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", spec.names("workloads"))
def test_workload_file(name):
    wl = spec.load_workload(name)
    assert NAME.match(name) and NAME.match(wl["traffic"]) and _line(wl["why"])
    cfg = spec.load_config(wl["config"])
    entry = spec.load_entry(wl["entry"])
    ref = spec.load_reference(entry.CHECK)
    for m in wl["per_layer"]:
        spec.load_metric(m)
    p = spec.params(wl, cfg)
    for key in ("n", "nb", "dtype", "sample_calls"):
        assert key in p
    assert wl["chips"] == 1
    compared = set(wl["limits"])
    recorded = set(getattr(ref, "RECORDED", ()))
    assert compared and not compared & recorded
    assert all(v >= 0 for v in wl["limits"].values())


@pytest.mark.parametrize("name", spec.names("configs"))
def test_config_file(name):
    cfg = spec.load_config(name)
    assert NAME.match(name) and _line(cfg["source"]) and cfg["source"].startswith("https://")
    for key in ("dtype", "nb", "uplo", "grid", "reduced", "assumed", "tune"):
        assert key in cfg
    for key in cfg["reduced"]:
        assert NAME.match(key) and key in cfg and key in cfg["source_values"]
        assert cfg[key] != cfg["source_values"][key]
    assert (ROOT / cfg["reference"]).is_file()


@pytest.mark.parametrize("name", spec.names("metrics"))
def test_metric_file(name):
    m = spec.load_metric(name)
    assert UNIT.match(m.UNIT) and m.BETTER in ("lower", "higher") and _line(m.LAYER)
    assert m.SOURCE in SOURCES and m.MOVES in spec.END_TO_END


@pytest.mark.parametrize("name", spec.names("workloads"))
def test_per_layer_metrics_move_what_the_cell_reports(name):
    wl = spec.load_workload(name)
    for m in wl["per_layer"]:
        assert spec.load_metric(m).MOVES in wl["end_to_end"], (name, m)


@pytest.mark.parametrize("name,base,group,moves", [
    ("device_idle_share", "device_idle_share", "", "call_s"),
    ("device_idle_share.host", "device_idle_share", "host", "call_s.host"),
    ("k6_roofline.host", "k6_roofline", "host", "call_s.host"),
    ("surface_s.host", "surface_s", "host", "call_s.host")])
def test_grouped_metric_names(name, base, group, moves):
    assert spec.split(name) == (base, group)
    m = spec.load_metric(name)
    assert m.NAME == name and m.MOVES == moves
    assert m.read is spec.load_metric(base).read
    assert spec.end_to_end_unit("call_s." + group if group else "call_s") == "s"


@pytest.mark.parametrize("name", ["no_such_metric.host", "device_idle_share/x", "a b"])
def test_unknown_metric_names_are_refused(name):
    with pytest.raises((ValueError, ModuleNotFoundError)):
        spec.load_metric(name)


def test_cells_agree_with_the_files():
    cells = [w["name"] for w in BENCH["workloads"]]
    assert set(cells) <= set(spec.names("workloads"))
    assert len(set((w["config"], w["traffic"]) for w in BENCH["workloads"])) == len(cells)
    for w in BENCH["workloads"]:
        wl = spec.load_workload(w["name"])
        assert (w["config"], w["traffic"], w["chips"], w["why"]) == (
            wl["config"], wl["traffic"], wl["chips"], wl["why"])
        assert set(w) == {"name", "config", "traffic", "chips", "why"}


def test_configs_agree_with_the_files():
    assert set(c["name"] for c in BENCH["configs"]) <= set(spec.names("configs"))
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        cfg = spec.load_config(c["name"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert c["source"] == cfg["source"] and c["reduced"] == cfg["reduced"]
        assert c["name"] in used and _line(c["why"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}


def test_end_to_end_agree_with_the_files():
    cells = [w["name"] for w in BENCH["workloads"]]
    for e in BENCH["end_to_end"]:
        assert e["unit"] == spec.end_to_end_unit(e["name"])
        assert e["source"] in ("host_clock", "device_trace") and e["better"] == "lower"
        assert 0.01 <= e["bound"] <= 0.25
        reporting = [c for c in cells if e["name"] in spec.load_workload(c)["end_to_end"]]
        assert e.get("workloads", cells) == reporting
    for c in cells:
        e2e = spec.load_workload(c)["end_to_end"]
        assert "setup_s" in e2e and len(e2e) >= 2


def test_per_layer_agree_with_the_files():
    cells = [w["name"] for w in BENCH["workloads"]]
    listed = sorted({m for c in cells for m in spec.load_workload(c)["per_layer"]})
    assert sorted(m["name"] for m in BENCH["per_layer"]) == listed
    for m in BENCH["per_layer"]:
        mod = spec.load_metric(m["name"])
        assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == (
            mod.UNIT, mod.BETTER, mod.SOURCE, mod.LAYER, mod.MOVES)
        assert m["workloads"] == [c for c in cells if m["name"] in
                                  spec.load_workload(c)["per_layer"]]
    for c in cells:
        assert spec.load_workload(c)["per_layer"]


def test_a_cell_removed_leaves_the_others(tmp_path, monkeypatch):
    """The harness finds each cell by its own file: without one cell's file
    the others still load."""
    for kind in ("workloads", "configs", "entries", "reference", "metrics"):
        src = spec.ROOT / kind
        dst = tmp_path / kind
        dst.mkdir()
        for f in src.iterdir():
            if f.is_file() and f.name != "cholesky-f32.n40960.json":
                (dst / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    assert "cholesky-f32.n40960" not in spec.names("workloads")
    for name in spec.names("workloads"):
        spec.load_workload(name)
    with pytest.raises(FileNotFoundError):
        spec.load_workload("cholesky-f32.n40960")
    with pytest.raises(ValueError):
        spec.load_workload("../BENCHMARK")
