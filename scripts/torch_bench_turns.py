"""The benchmark's cells from two checkouts in turns on one CUDA card: a
parent-against-change comparison in one machine.

    python3 scripts/torch_bench_turns.py --parent DIR --cell NAME [--cell NAME ...] \
        --seeds S1,S2,... [--trace 0|1] [--seconds 51] [--out FILE]

``DIR`` is another checkout, e.g. the parent commit unpacked with
``git archive`` into a directory that ``.gitignore`` lists; this checkout
is the change. For each cell and seed both run the benchmark's command
from their own root (``python3 portbench/run.py --workload NAME --seed S
--seconds T --trace X``), the parent first at the first, third, ... seed
and the change first at the others (P C C P for two seeds). Each run is
one JSON line on standard output and in ``--out``: the side (P or C), the
cell, the seed, the exit code, the wall seconds, the harness's result line
and its ``run`` line. A checkout's first run builds its nvcc libraries
inside its ``setup_s``.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run_once(root: Path, cell: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, "portbench/run.py", "--workload", cell, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=root, capture_output=True, text=True)
    out = p.stdout.strip().splitlines()
    return {"rc": p.returncode, "wall": time.perf_counter() - t0,
            "result": out[-1] if out else None,
            "run": [ln for ln in p.stderr.splitlines() if ln.startswith("run {")],
            "stderr_tail": p.stderr[-1500:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--cell", action="append", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    sides = {"P": args.parent.resolve(), "C": ROOT}
    seeds = [int(s) for s in args.seeds.split(",")]
    rc = 0
    for cell in args.cell:
        for i, seed in enumerate(seeds):
            for side in ("P", "C") if i % 2 == 0 else ("C", "P"):
                rec = {"side": side, "cell": cell, "seed": seed, "trace": args.trace,
                       **run_once(sides[side], cell, seed, args.seconds, args.trace)}
                rc = rc or rec["rc"]
                line = json.dumps(rec)
                print(line, flush=True)
                if args.out:
                    args.out.parent.mkdir(parents=True, exist_ok=True)
                    with args.out.open("a") as f:
                        f.write(line + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
