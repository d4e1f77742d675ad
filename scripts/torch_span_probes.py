"""Measurements of the program's span recorder (``dlaf_tpu_torch.spans``) on one CUDA card.

    python3 scripts/torch_span_probes.py cost
    python3 scripts/torch_span_probes.py on_off --cell cholesky-f32.n40960 --seed 2147506001
    python3 scripts/torch_span_probes.py readers --cell cholesky-f32.n40960 --seed 2147506011
    python3 scripts/torch_span_probes.py eigh_timers

Run from the root of a checkout; ``--cpu`` runs any probe on the CPU at a
tiny size, to rehearse it.

- ``cost``: what a span costs the host, off and on. 200,000 spans
  ``cholesky.solve``, 360 to a top-level ``cholesky`` span as in a call at
  n = 40960, drained after each call; each side twice in turns (off, on,
  off, on), in microseconds a span, beside the empty loop's.
- ``on_off``: ``portbench``'s untraced run of ``--cell`` (its end-to-end
  metrics) four times in this one process, the recorder off, on, on, off
  (seeds ``--seed`` to ``--seed`` + 3), with the records and drops of each.
- ``readers``: a traced run of ``--cell`` (``--trace 1``) with the
  program-span readers added to the cell's own per-layer metrics
  (``panel_idle_share`` and ``panel_launches_per_call`` in the whole-matrix
  Cholesky cells, ``copy_gbps.host`` and ``surface_idle_share.host`` in
  the ``pspotrf`` cells); the cell's file is not changed. Prints the
  result line and the spans of the last traced call by name.
- ``eigh_timers``: ``eigh_large(timers=True)`` at n = 8192, band 128,
  ``rec_chunks`` 1 and 2: the stage seconds (the recorder's spans), their
  sum against the call's wall time, each stage's peak of allocated memory,
  and the result bit-equal to a call without timers.

Each probe prints JSON lines; the first is the card's name and power limit
as nvidia-smi gives them.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "portbench",
                                                           "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "portbench", "triton"))
import torch  # noqa: E402

READERS = {"cholesky": ["panel_idle_share", "panel_launches_per_call"],
           "pspotrf": ["copy_gbps.host", "surface_idle_share.host"]}
TINY = {"cholesky": {"n": 512, "nb": 64}, "pspotrf": {"n": 448, "nb": 64}}


def emit(probe: str, **kw) -> None:
    print(json.dumps({"probe": probe, **kw}), flush=True)


def _entry(cell: str) -> str:
    from portbench import spec
    return spec.load_workload(cell)["entry"]


def _where(cell: str, cpu: bool) -> dict:
    return {"device": "cpu", "overrides": TINY[_entry(cell)]} if cpu else {}


def probe_cost(args) -> None:
    from dlaf_tpu_torch import spans
    n, per_call = (20_000 if args.cpu else 200_000), 360
    out = {"off": [], "on": []}
    for on in (False, True, False, True):
        (spans.enable if on else spans.disable)()
        t = time.perf_counter()
        for _ in range(n // per_call):
            with spans.span("cholesky"):
                for _ in range(per_call - 1):
                    with spans.span("cholesky.solve"):
                        pass
            spans.drain()
        out["on" if on else "off"].append((time.perf_counter() - t) / n * 1e6)
        spans.disable()
        spans.drain()
    t = time.perf_counter()
    for _ in range(n):
        pass
    emit("cost", spans=n, spans_a_call=per_call, off_us=out["off"], on_us=out["on"],
         empty_loop_us=(time.perf_counter() - t) / n * 1e6)


def probe_on_off(args) -> None:
    from dlaf_tpu_torch import spans
    from portbench import harness
    for k, on in enumerate((False, True, True, False)):
        spans.drain()
        (spans.enable if on else spans.disable)()
        r = harness.run(args.cell, args.seed + k, args.seconds, False, time.perf_counter(),
                        log=io.StringIO(), **_where(args.cell, args.cpu))
        spans.disable()
        recs, dropped = spans.drain()
        emit("on_off", cell=args.cell, seed=args.seed + k, recorder_on=on,
             metrics=r["metrics"], correct=r["correct"], attempted=r["attempted"],
             records=len(recs), dropped=dropped)


def probe_readers(args) -> None:
    from portbench import harness, program_spans, spec
    load = spec.load_workload

    def with_readers(name):
        wl = load(name)
        return {**wl, "per_layer": wl["per_layer"] + READERS[wl["entry"]]}
    spec.load_workload = with_readers
    log = io.StringIO()
    r = harness.run(args.cell, args.seed, args.seconds, True, T_START, log=log,
                    **_where(args.cell, args.cpu))
    recs = program_spans._kept
    last = max((x.call for x in recs if x.parent == -1), default=None)
    names: dict = {}
    for x in recs:
        if x.call == last:
            names[x.name] = names.get(x.name, 0) + 1
    emit("readers", cell=args.cell, seed=args.seed, result=r, spans_last_call=names,
         log_tail=log.getvalue()[-1500:])


def probe_eigh_timers(args) -> None:
    from dlaf_tpu_torch.algos.eigensolver import large
    from dlaf_tpu_torch.matrix import generators as gen
    dev = torch.device("cpu" if args.cpu else "cuda")
    n, band = (256, 32) if args.cpu else (8192, 128)
    a = gen.random_hermitian(torch.Generator(device=dev).manual_seed(args.seed), n,
                             torch.float32)
    w0, v0 = large.eigh_large(a, band=band)
    for chunks in (1, 2):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        w, v, st = large.eigh_large(a, band=band, rec_chunks=chunks, timers=True)
        wall = time.perf_counter() - t
        stages = sum(x for k, x in st.items() if k not in ("stage4a_rechase", "stage4b_apply"))
        emit("eigh_timers", n=n, band=band, rec_chunks=chunks, wall_s=wall, stage_s=st,
             stages_sum_s=stages,
             peak_gib={k: x / 2**30 for k, x in large.stage_peak_bytes.items()},
             bit_equal=bool(torch.equal(w, w0) and torch.equal(v, v0)))


PROBES = {"cost": probe_cost, "on_off": probe_on_off, "readers": probe_readers,
          "eigh_timers": probe_eigh_timers}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probe", choices=sorted(PROBES))
    ap.add_argument("--cell", default="cholesky-f32.n40960")
    ap.add_argument("--seed", type=int, default=2**31 + 5)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("torch_span_probes: no CUDA device", file=sys.stderr)
        return 1
    smi = "cpu" if args.cpu else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    emit("card", smi=smi, torch=torch.__version__)
    PROBES[args.probe](args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
