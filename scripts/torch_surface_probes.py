"""Measurements of the ScaLAPACK surface's host copies on one CUDA card.

    python3 scripts/torch_surface_probes.py rates [--n 20480]
    python3 scripts/torch_surface_probes.py ring [--n 20480] [--rings 32x4,64x3] [--reps 3]
    python3 scripts/torch_surface_probes.py touch [--n 20480]
    python3 scripts/torch_surface_probes.py counter [--seed 2147523201] [--seconds 8]

Run from the root of a checkout.

- ``rates``: the copies an n x n f32 matrix (n = 20480: 1.5625 GiB) can
  take between host and card, each three times: one pinned copy each way
  (CUDA events), today's pageable copies (``.to(card)`` from a resident
  array, ``.cpu()`` into a new tensor), and on the host torch's CPU
  ``copy_`` from a resident pageable array into pinned memory, and into a
  newly allocated tensor whose pages the copy touches first, at the
  intra-op thread count and on one thread.
- ``ring``: the surface's two copies (``api.scalapack._on`` and
  ``_to_host``) of the same matrix through staging rings of several block
  sizes and slot counts (``--rings``, MiB x slots; the module's constants
  patched, a new ring for each), beside the direct copies, in seconds a
  copy (host clock around a synchronized copy; median of ``--reps`` after
  one warm-up), the rings taken in order and then in reverse order.
- ``touch``: the host copy that sets the pace of the copy to the host:
  pinned memory into a newly allocated tensor (its pages touched first by
  the copy), and into a new anonymous mapping advised as huge pages
  (``madvise(MADV_HUGEPAGE)``), beside the kernel's transparent huge page
  setting as ``/sys/kernel/mm/transparent_hugepage`` reads. (Python's
  ``mmap`` maps shared memory by default, so the second copy also pays
  for shared pages.)
- ``counter``: the benchmark's two Cholesky cells run in this process
  (``portbench.harness.run``, ``--seconds`` each, untraced) with the span
  recorder on: the staged copies counted (``scalapack.staged_copies``) over
  the cell's calls (warm-up and window), and the ``surface.to_card`` /
  ``surface.to_host`` spans' attributes as they occur.

Each probe prints JSON lines; the first is the card's name and power limit
as nvidia-smi gives them.
"""
from __future__ import annotations

import argparse
import json
import mmap
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import numpy as np  # noqa: E402
import torch  # noqa: E402

REPS = 3
RINGS = ",".join(f"{mib}x{slots}" for mib in (4, 8, 16, 32, 64) for slots in (2, 3, 4))


def emit(probe: str, **kw) -> None:
    print(json.dumps({"probe": probe, **kw}), flush=True)


def _smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True)
    return r.stdout.strip()


def _wall(fn, dev) -> float:
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def _events(fn, dev) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def _rate(nbytes: int, seconds: list) -> dict:
    return {"s": seconds, "gbps": nbytes / min(seconds) / 1e9}


def probe_rates(n: int, dev) -> None:
    card = torch.rand((n, n), device=dev)
    host = torch.empty((n, n))
    host.fill_(1.0)
    pinned = torch.empty((n, n), pin_memory=True)
    pinned.fill_(2.0)
    nbytes = card.nbytes
    out = {"n": n, "bytes": nbytes, "threads": torch.get_num_threads(),
           "cpu_count": os.cpu_count()}
    out["h2d_pinned"] = _rate(nbytes, [_events(lambda: card.copy_(pinned, non_blocking=True),
                                               dev) for _ in range(REPS)])
    out["d2h_pinned"] = _rate(nbytes, [_events(lambda: pinned.copy_(card, non_blocking=True),
                                               dev) for _ in range(REPS)])
    out["h2d_pageable"] = _rate(nbytes, [_wall(lambda: card.copy_(host), dev)
                                         for _ in range(REPS)])
    out["d2h_pageable_new"] = _rate(nbytes, [_wall(lambda: card.cpu(), dev) for _ in range(REPS)])
    threads = torch.get_num_threads()
    for k in (threads, 1):
        torch.set_num_threads(k)
        try:
            out[f"cpu_to_pinned_t{k}"] = _rate(nbytes, [_wall(lambda: pinned.copy_(host), dev)
                                                        for _ in range(REPS)])
            out[f"cpu_to_new_t{k}"] = _rate(nbytes, [
                _wall(lambda: torch.empty((n, n)).copy_(pinned), dev) for _ in range(REPS)])
            out[f"cpu_pinned_to_resident_t{k}"] = _rate(nbytes, [
                _wall(lambda: host.copy_(pinned), dev) for _ in range(REPS)])
        finally:
            torch.set_num_threads(threads)
    emit("rates", **out)


def probe_ring(n: int, dev, rings: str, reps: int) -> None:
    from dlaf_tpu_torch.api import scalapack as sl
    a = torch.rand((n, n), device=dev).cpu().numpy()
    base = (sl._BLOCK_BYTES, sl._SLOTS, sl._RING)

    def times(direct: bool) -> dict:
        to_card, to_host = [], []
        for _ in range(reps + 1):
            holder = {}
            if direct:
                to_card.append(_wall(lambda: holder.update(
                    t=torch.from_numpy(a).to(dev)), dev))
                to_host.append(_wall(lambda: holder.update(h=holder["t"].cpu().numpy()), dev))
            else:
                to_card.append(_wall(lambda: holder.update(t=sl._on(a, dev)), dev))
                to_host.append(_wall(lambda: holder.update(h=sl._to_host(holder["t"])), dev))
            del holder
        return {"to_card_s": statistics.median(to_card[1:]),
                "to_host_s": statistics.median(to_host[1:]), "first": [to_card[0], to_host[0]]}

    order = [tuple(int(x) for x in r.split("x")) for r in rings.split(",")]
    emit("ring", block_mib=None, slots=None, **times(True))
    try:
        for mib, slots in order + order[::-1]:
            sl._BLOCK_BYTES, sl._SLOTS, sl._RING = mib << 20, slots, sl._StagingRing()
            emit("ring", block_mib=mib, slots=slots, **times(False))
    finally:
        sl._BLOCK_BYTES, sl._SLOTS, sl._RING = base
    emit("ring", block_mib=None, slots=None, **times(True))


def _huge(n: int) -> torch.Tensor:
    m = mmap.mmap(-1, n * n * 4)
    m.madvise(mmap.MADV_HUGEPAGE)
    return torch.from_numpy(np.frombuffer(m, dtype=np.float32).reshape(n, n))


def probe_touch(n: int, dev) -> None:
    thp = {}
    for f in ("enabled", "defrag"):
        try:
            with open(f"/sys/kernel/mm/transparent_hugepage/{f}") as fh:
                thp[f] = fh.read().strip()
        except OSError as e:
            thp[f] = repr(e)
    pinned = torch.empty((n, n), pin_memory=True)
    pinned.fill_(2.0)
    nbytes = pinned.nbytes
    out = {"n": n, "thp": thp, "threads": torch.get_num_threads()}
    for _ in range(2):
        out.setdefault("new", []).append(_wall(lambda: torch.empty((n, n)).copy_(pinned), dev))
        out.setdefault("huge", []).append(_wall(lambda: _huge(n).copy_(pinned), dev))
    out["gbps"] = {k: nbytes / min(out[k]) / 1e9 for k in ("new", "huge")}
    emit("touch", **out)


def probe_counter(seed: int, seconds: float) -> None:
    from dlaf_tpu_torch import spans
    from dlaf_tpu_torch.api import scalapack as sl
    from portbench import harness, spec
    for cell in ("cholesky-f32.pspotrf-n20480", "cholesky-f32.n40960"):
        wl = spec.load_workload(cell)
        warmup = int(spec.params(wl, spec.load_config(wl["config"])).get("warmup_calls", 1))
        before = sl.staged_copies
        spans.enable()
        try:
            result = harness.run(cell, seed, seconds, False, time.perf_counter(),
                                 log=sys.stdout)
        finally:
            spans.disable()
        recs, dropped = spans.drain()
        copies = [(r.name, r.attrs) for r in recs
                  if r.name in ("surface.to_card", "surface.to_host")]
        attrs = sorted({json.dumps(c, sort_keys=True) for c in copies})
        calls = warmup + result["attempted"]
        emit("counter", cell=cell, seed=seed, calls=calls, correct=result["correct"],
             staged_copies=sl.staged_copies - before,
             per_call=(sl.staged_copies - before) / calls, copy_spans=len(copies),
             copy_span_attrs=[json.loads(a) for a in attrs], dropped=dropped)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probes", nargs="+", choices=("rates", "ring", "touch", "counter"))
    ap.add_argument("--n", type=int, default=20480)
    ap.add_argument("--rings", default=RINGS)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--seed", type=int, default=2147523201)
    ap.add_argument("--seconds", type=float, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("these probes measure the card: no CUDA device")
    dev = torch.device("cuda", 0)
    emit("device", smi=_smi(), name=torch.cuda.get_device_name(dev), torch=torch.__version__)
    for p in args.probes:
        if p == "ring":
            probe_ring(args.n, dev, args.rings, args.reps)
        elif p == "counter":
            probe_counter(args.seed, args.seconds)
        else:
            {"rates": probe_rates, "touch": probe_touch}[p](args.n, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
