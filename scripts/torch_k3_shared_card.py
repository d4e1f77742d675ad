"""K3 launched by several processes that share one CUDA card.

    python3 scripts/torch_k3_shared_card.py [n] [ranks]

The replicated stage 2 of ``eigh_dist`` launches kernel K3 on every rank,
each with its own sweep chunk. K3 is one cooperative launch sized to every
block the card can hold at once, whose lanes wait by spinning on their
neighbours' step counts; gloo ranks that share a card (as ``chip_smoke.py``'s
grid phases run them) each make that launch at the same time. This script
checks that this works before anything depends on it: it builds the
kernels, chases one random f32 band (n = 4096 by default, b = 128) in this
process with the full record, then spawns ``ranks`` gloo ranks (default 4)
on the card, each chasing the same band with the record of its chunk
(sweep_lo = rank * chunk, chunk = ceil((n - 2) / ranks); the last chunk
runs past the last sweep), all launching together after a barrier. It
checks that d and e are bit-equal on every rank and to the one-process
run, that each rank's record is bit-equal to its rows of the full record,
and that the rows past the last sweep read tau = 0, and prints one JSON
line with the launch plan and each rank's seconds (launch to finish, and
the launch alone with the others idle). A hang ends at ``spawn_grid``'s
timeout with an error. Exits 1 without a CUDA device.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

B = 128


def _band_strips(n: int, device) -> torch.Tensor:
    from dlaf_tpu_torch.algos.eigensolver.band_strips import band_to_strips, n_strips
    g = torch.Generator(device=device).manual_seed(21)
    a = torch.randn((n, n), generator=g, device=device)
    a = a + a.T
    r = torch.arange(n, device=device)
    band = torch.where((r[:, None] - r[None, :]).abs() <= B, a, 0)
    strips = band_to_strips(band, B)
    pad = n_strips(n, B) + 3 - strips.shape[0]
    return torch.cat([strips, strips.new_zeros((pad, *strips.shape[1:]))]).contiguous()


def _rank(n: int, grid, device) -> dict:
    """One rank: its chunk of the record, timed with every rank launching
    at once, then again alone (the others wait at a barrier)."""
    import torch.distributed as dist

    from dlaf_tpu_torch.ops.kernels.band2tridiag import band_to_tridiag_strips_kernel
    strips = _band_strips(n, device)
    chunk = -(-(n - 2) // grid.size)
    lo = grid.rank * chunk
    band_to_tridiag_strips_kernel(strips, n, B, lo, chunk)        # warm-up
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    d, e, vs, taus = band_to_tridiag_strips_kernel(strips, n, B, lo, chunk)
    torch.cuda.synchronize()
    together = time.perf_counter() - t0
    alone = None
    for r in range(grid.size):
        dist.barrier()
        if r == grid.rank:
            t0 = time.perf_counter()
            band_to_tridiag_strips_kernel(strips, n, B, lo, chunk)
            torch.cuda.synchronize()
            alone = time.perf_counter() - t0
    dist.barrier()
    return {"rank": grid.rank, "lo": lo, "chunk": chunk, "seconds_together": together,
            "seconds_alone": alone, "d": d.cpu().numpy(), "e": e.cpu().numpy(),
            "vs": vs.cpu().numpy(), "taus": taus.cpu().numpy()}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch_k3_shared_card: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from dlaf_tpu_torch.comm.launch import spawn_grid
    from dlaf_tpu_torch.ops.kernels import _build
    from dlaf_tpu_torch.ops.kernels.band2tridiag import (band_to_tridiag_strips_kernel,
                                                         chase_plan)
    n = int(argv[0]) if argv else 4096
    nranks = int(argv[1]) if len(argv) > 1 else 4
    dev = torch.device("cuda", 0)
    _build.build_all()
    strips = _band_strips(n, dev)
    band_to_tridiag_strips_kernel(strips, n, B)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d0, e0, vs0, t0_ = band_to_tridiag_strips_kernel(strips, n, B)
    torch.cuda.synchronize()
    one = time.perf_counter() - t0
    d0, e0, vs0, t0_ = (x.cpu().numpy() for x in (d0, e0, vs0, t0_))
    t_spawn = time.perf_counter()
    outs = spawn_grid(functools.partial(_rank, n), (1, nranks), backend="gloo", device="cuda",
                      timeout=600)
    spawn_s = time.perf_counter() - t_spawn
    nsweeps = n - 2
    checks = {"d_e_equal_across_ranks": all(np.array_equal(o["d"], outs[0]["d"]) and
                                            np.array_equal(o["e"], outs[0]["e"]) for o in outs),
              "d_e_equal_to_one_process": np.array_equal(outs[0]["d"], d0) and
              np.array_equal(outs[0]["e"], e0)}
    rows_ok, tail_zero = True, True
    for o in outs:
        k = max(0, min(o["chunk"], nsweeps - o["lo"]))
        rows_ok &= np.array_equal(o["vs"][:k], vs0[o["lo"]:o["lo"] + k]) and \
            np.array_equal(o["taus"][:k], t0_[o["lo"]:o["lo"] + k])
        tail_zero &= not o["taus"][k:].any() and not o["vs"][k:].any()
    checks["records_equal_full_rows"] = bool(rows_ok)
    checks["rows_past_last_sweep_zero"] = bool(tail_zero)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"probe": "k3_shared_card", "n": n, "b": B, "ranks": nranks,
                      "plan": chase_plan(n, B, torch.float32)._asdict(),
                      "one_process_seconds": one, "spawn_seconds": spawn_s,
                      "rank_seconds_together": [o["seconds_together"] for o in outs],
                      "rank_seconds_alone": [o["seconds_alone"] for o in outs],
                      "chunks": [[o["lo"], o["chunk"]] for o in outs], **checks,
                      "nvidia_smi": smi}), flush=True)
    return 0 if all(checks.values()) else 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
