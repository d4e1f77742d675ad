"""Find a cell, a configuration, an entry, a reference or a metric by name.

Everything that belongs to one configuration, one cell or one per-layer
metric is a file of its own, found by its name:

- ``configs/<config>.json``: the deployment (dtype, tile size, uplo, grid,
  the program's tune parameters, its source, what was cut and assumed);
- ``workloads/<cell>.json``: the cell (its config, its traffic name, the
  entry it drives, the traffic's parameters, chips, why, the end-to-end and
  per-layer metrics it reports, and the limit of each number the output
  check compares);
- ``entries/<entry>.py``: how a call of the program is made and what of its
  output is judged;
- ``reference/<check>.py``: the plain reference and its comparison;
- ``metrics/<metric>.py``: one reader per per-layer metric.

A metric's name may carry a group after a dot: ``call_s.host`` is the
window's time a call in the cells whose runs spread alike (a bound is per
metric), and ``device_idle_share.host`` is read by ``metrics/device_idle_share.py``
and moves ``call_s.host``, the same group of the end-to-end metric its
reader moves. A new group is a new name in the files, not a new reader.

A later change adds a configuration, a cell or a metric by adding files.
"""
from __future__ import annotations

import importlib
import json
import re
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
MODULE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")
# the end-to-end metrics by their name before any group
END_TO_END = {"call_s": "s", "call_p95_s": "s", "peak_mem_gib": "GiB", "setup_s": "s"}
WORKLOAD_KEYS = {"config", "traffic", "entry", "chips", "why", "params", "end_to_end",
                 "per_layer", "limits"}
METRIC_ATTRS = ("NAME", "UNIT", "BETTER", "LAYER", "SOURCE", "MOVES")


def split(name: str) -> tuple:
    """``(base, group)`` of a metric's name: ``("call_s", "host")`` for
    ``call_s.host``, ``("call_s", "")`` for ``call_s``."""
    base, _, group = _checked(name).partition(".")
    return base, group


def grouped(base: str, group: str) -> str:
    return f"{base}.{group}" if group else base


def end_to_end_unit(name: str) -> str:
    """The unit of an end-to-end metric's name; KeyError if unknown."""
    return END_TO_END[split(name)[0]]


def _checked(name: str, pattern=NAME) -> str:
    if not isinstance(name, str) or not pattern.match(name):
        raise ValueError(f"not a valid name: {name!r}")
    return name


def _json(kind: str, name: str) -> dict:
    path = ROOT / kind / f"{_checked(name)}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path.relative_to(ROOT)})")
    return json.loads(path.read_text())


def load_workload(name: str) -> dict:
    wl = _json("workloads", name)
    missing = WORKLOAD_KEYS - set(wl)
    if missing:
        raise ValueError(f"workload {name!r} lacks {sorted(missing)}")
    unknown = [m for m in wl["end_to_end"] if split(m)[0] not in END_TO_END]
    if unknown or "setup_s" not in wl["end_to_end"]:
        raise ValueError(f"workload {name!r}: end-to-end metrics {wl['end_to_end']} "
                         f"(known: {sorted(END_TO_END)}, setup_s required)")
    return wl


def load_config(name: str) -> dict:
    return _json("configs", name)


def _module(kind: str, name: str):
    return importlib.import_module(f"portbench.{kind}.{_checked(name, MODULE)}")


def load_entry(name: str):
    return _module("entries", name)


def load_reference(name: str):
    return _module("reference", name)


def load_metric(name: str):
    """The reader of per-layer metric ``name`` (``metrics/<base>.py``), as
    a namespace whose ``NAME`` is ``name`` and whose ``MOVES`` carries the
    name's group."""
    base, group = split(name)
    mod = _module("metrics", base)
    missing = [a for a in METRIC_ATTRS if not hasattr(mod, a)]
    if missing or mod.NAME != base or not callable(getattr(mod, "read", None)):
        raise ValueError(f"metric {name!r}: needs {METRIC_ATTRS}, NAME == file name, read()")
    attrs = {a: getattr(mod, a) for a in METRIC_ATTRS}
    attrs.update(NAME=name, MOVES=grouped(mod.MOVES, group), read=mod.read,
                 SPANS=getattr(mod, "SPANS", {}))
    return types.SimpleNamespace(**attrs)


def params(wl: dict, cfg: dict) -> dict:
    """The cell's parameters: the configuration's keys, then the traffic's."""
    p = {k: v for k, v in cfg.items() if k not in ("tune", "reduced", "assumed", "source")}
    p.update(wl["params"])
    return p


def names(kind: str) -> list:
    """Every name of a kind that has a file (``workloads``, ``configs``,
    ``metrics``)."""
    suffix = ".py" if kind == "metrics" else ".json"
    return sorted(p.name[:-len(suffix)] for p in (ROOT / kind).glob(f"*{suffix}")
                  if p.name != "__init__.py")
