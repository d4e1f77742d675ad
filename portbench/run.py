#!/usr/bin/env python3
"""The benchmark of dlaf_tpu_torch on one NVIDIA H100: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Prints one JSON object as the last line of
standard output (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number the output check compared, beside its limit), and on standard error
a ``run`` line for the record (the window, the calls' spread, the parts of
set-up, the build's seconds), then the compared numbers as its last lines. Exits with another code than 0, and
prints no result, where there is no CUDA device (or fewer than the cell
asks for), or where JAX or the JAX package ``dlaf_tpu`` was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's tune parameters come from the cell's configuration
    # alone, not from the environment
    for key in [k for k in os.environ if k.startswith("DLAF_TPU_TORCH_")]:
        del os.environ[key]
    # build and kernel caches at fixed paths inside the checkout (the
    # program's own nvcc libraries go to build/dlaf_tpu_torch/)
    cache = ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path.insert(0, str(ROOT))
    try:
        from portbench import harness
        import dlaf_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: cannot import the program: {e}", file=sys.stderr)
        return 3
    try:
        result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    except harness.Refused as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
