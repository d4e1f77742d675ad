#!/usr/bin/env python3
"""The control of a cell's output check: what the check must reject.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--n N] [--side S]

The control is the computation put in the program's place one precision
below the configuration's: f32 with TF32 products (the configuration states
f32 with TF32 off). For a Cholesky cell it is the plain reference's tiled
factorization (``reference/cholesky.py:blocked_cholesky``) run with TF32
products; for the eigensolver cell, where no plain reference decomposes in
steps, it is the program itself with PyTorch's TF32 switches on, the path
that a change to its matmuls would take. Each seed's input is made as the
benchmark makes it and the control's output is judged by the cell's own
comparison. Prints one JSON line a seed: the numbers, the cell's limits and
whether the check rejects the output. Runs on the card only.

``--side`` puts another computation in the program's place, judged the same
way on the same inputs: ``program`` (the program itself, as the harness runs
it) or ``witness`` (PyTorch's own f32 routine, ``torch.linalg.eigh`` or
``torch.linalg.cholesky``, with TF32 off: a second reading of what the
configuration's precision gives).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def control_output(p: dict, entry, a):
    """The control's output for input ``a``, as ``entry.answer`` gives it."""
    import torch
    from portbench.reference import cholesky as ref_chol
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        if entry.CHECK == "cholesky":
            return {"factor": ref_chol.blocked_cholesky(a, int(p["nb"]), p["uplo"]),
                    "uplo": p["uplo"]}
        state = entry.prepare(p, a)
        out = entry.answer(entry.call(state), p)
        del state
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def witness_output(p: dict, entry, a):
    """PyTorch's own routine in the configuration's precision, TF32 off."""
    import torch
    n = int(p["n"])
    if entry.CHECK == "cholesky":
        lower = p["uplo"] == "L"
        f = torch.linalg.cholesky(a, upper=not lower)
        keep = torch.triu(a, 1) if lower else torch.tril(a, -1)
        return {"factor": f + keep, "uplo": p["uplo"]}
    w, v = torch.linalg.eigh(a)
    return {"w": w[:n], "v": v[:n, :n]}


def program_output(p: dict, entry, a):
    state = entry.prepare(p, a)
    out = entry.answer(entry.call(state), p)
    del state
    return out


SIDES = {"control": control_output, "witness": witness_output, "program": program_output}


def readings(cell: str, seeds, n=None, device="cuda:0", side="control") -> list:
    import torch
    from portbench import spec, traffic
    wl = spec.load_workload(cell)
    cfg = spec.load_config(wl["config"])
    p = spec.params(wl, cfg)
    if n:
        p["n"] = n
    entry = spec.load_entry(wl["entry"])
    ref = spec.load_reference(entry.CHECK)
    from dlaf_tpu_torch.tune import reset_tune_parameters, set_tune_parameters
    reset_tune_parameters()
    set_tune_parameters(**cfg.get("tune", {}))
    dev = torch.device(device)
    rows = []
    for seed in seeds:
        t = time.perf_counter()
        a = traffic.make_matrix(p, seed, dev)
        out = SIDES[side](p, entry, a)
        numbers = ref.judge(a, **out)
        del a, out
        rejected = any(v > wl["limits"][k] for k, v in numbers.items()
                       if k not in getattr(ref, "RECORDED", ()))
        rows.append({"cell": cell, "side": side, "n": p["n"], "seed": seed,
                     "numbers": numbers, "limits": wl["limits"], "rejected": rejected,
                     "seconds": time.perf_counter() - t})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--side", choices=sorted(SIDES), default="control")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    for row in readings(args.workload, [int(s) for s in args.seeds.split(",")], args.n,
                        side=args.side):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
