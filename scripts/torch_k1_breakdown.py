"""Where K1's time goes on one CUDA card: each part of its slab step switched off in turn.

    python3 scripts/torch_k1_breakdown.py

Builds copies of ``dlaf_tpu_torch/csrc/potrf_tile.cu`` (into
``build/dlaf_tpu_torch/breakdown/``) in which one part of every slab step
does nothing (its loop bound set to 0 at compile time) and times each copy
on an nb = 256 and an nb = 512 f32 tile (upper, CUDA events, 200
launches): the difference from the full kernel is that part's share. The
copies compute wrong factors on purpose and are only timed. The parts:
the trailing update, the diagonal factor, the solve, the slab gather,
the cluster barriers (with the gather off, so that no block reads another's
shared memory unsynchronized), and all of them but the tile's read and
write. Prints one JSON line a copy and nb, and the card's name and power
limit last.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

if not torch.cuda.is_available():
    print("torch_k1_breakdown: no CUDA device", file=sys.stderr)
    sys.exit(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from dlaf_tpu_torch.ops.kernels import _build  # noqa: E402

# (anchor in the source, the same with a switch); each anchor occurs once
EDITS = [
    ("for (int e = tid; e < items; e += kThreads) {",
     "for (int e = tid; e < (PART_UPDATE ? items : 0); e += kThreads) {"),
    ("    if (warp == 0) {\n      float d[kSlab];", "    if (PART_FACTOR && warp == 0) {\n      float d[kSlab];"),
    ("for (int c = r0 + tid; c < nb; c += kThreads) {",
     "for (int c = r0 + tid; c < (PART_SOLVE ? nb : 0); c += kThreads) {"),
    ("for (int e0 = tid; e0 < total; e0 += kThreads * kPull) {",
     "for (int e0 = tid; e0 < (PART_GATHER ? total : 0); e0 += kThreads * kPull) {"),
    ("    cluster.sync();\n  };", "    if (PART_BARRIER) cluster.sync(); else __syncthreads();\n  };"),
    ("for (int e = tid; e < pwp * ncol; e += kThreads) {",
     "for (int e = tid; e < (PART_WRITEBACK ? pwp * ncol : 0); e += kThreads) {"),
]
ALL = ("PART_UPDATE", "PART_FACTOR", "PART_SOLVE", "PART_GATHER", "PART_BARRIER", "PART_WRITEBACK")
COPIES = {
    "full": (),
    "no_update": ("PART_UPDATE",),
    "no_factor": ("PART_FACTOR",),
    "no_solve": ("PART_SOLVE",),
    "no_gather": ("PART_GATHER",),
    "no_gather_no_barrier": ("PART_GATHER", "PART_BARRIER"),
    "tile_io_only": ALL,
}


def build() -> dict:
    src = (_build.CSRC / "potrf_tile.cu").read_text()
    for old, new in EDITS:
        if src.count(old) != 1:
            raise RuntimeError(f"potrf_tile.cu changed: anchor not found once: {old!r}")
        src = src.replace(old, new)
    out = _build.BUILD_DIR / "breakdown"
    out.mkdir(parents=True, exist_ok=True)
    path = out / "potrf_tile_parts.cu"
    path.write_text(src)
    procs = {}
    for name, off in COPIES.items():
        flags = [f"-D{p}={0 if p in off else 1}" for p in ALL]
        so = out / f"libpotrf_tile_{name}.so"
        procs[name] = (so, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(so),
                                             str(path)], stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.dlaf_potrf_tile.argtypes = _build.SIGNATURES["potrf_tile"]["dlaf_potrf_tile"]
        lib.dlaf_potrf_tile.restype = ctypes.c_int
        libs[name] = lib
    return libs


def timed_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


if __name__ == "__main__":
    dev = torch.device("cuda", 0)
    libs = build()
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev).manual_seed(1)
    for nb in (256, 512):
        a = torch.rand((nb, nb), generator=g, device=dev)
        a = a @ a.T + nb * torch.eye(nb, device=dev)
        out = torch.empty_like(a)
        for name, lib in libs.items():
            def run():
                rc = lib.dlaf_potrf_tile(a.data_ptr(), nb, out.data_ptr(), nb, None, nb, 1, 0, stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            print(json.dumps({"k1_part_off": name, "nb": nb, "ms": timed_ms(run, 200)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
