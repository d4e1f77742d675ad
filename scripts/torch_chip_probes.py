"""Measurements of the PyTorch/H100 port beside chip_smoke.py's checks, on one CUDA card.

    python3 scripts/torch_chip_probes.py accumulation bf16_potrf k5_levers[=BASELINE.cu] \
        k3_levers[=BASELINE.cu,...] stage2 k3_loads k6_levers[=BASELINE.cu]

- ``accumulation``: K2 (``csrc/ksub_tf32x3.cu``) as built, where each
  32-deep k step is summed on the tensor cores from zero and then added
  into a second f32 accumulator, against a copy of its source (built into
  ``build/dlaf_tpu_torch/accumulation/``) patched to keep one tensor-core
  accumulator over all of k, each held to K2's error bound
  eps32 (2k max|x| max|y| + max|c|) against an f64 product, on
  chip_smoke.py's K2 shapes.
- ``bf16_potrf``: ``dlaf_tpu_torch.potrf`` on a bf16 matrix (n = 4096,
  nb = 512, U and L): whether it runs, and its residual and its distance
  from the f32 factor of the same (bf16-rounded) input.
- ``k5_levers``: K5 (``csrc/bt_apply.cu``) at the heaviest step of
  ``eigh_large`` n = 32768 (k = 8 groups, 2,020 chases, nev = 32768,
  band 128, on random WY slabs made by ``bt._group_vt_all``), and K4 on one
  256-chase group, timed in turns as built and as copies of its source
  (built into ``build/dlaf_tpu_torch/levers/``) patched to ``dense``
  (the zero rule off: every chunk loaded and multiplied whole, the
  tensor-core lever alone) and ``stream_only`` (no tensor-core product:
  what the V/V2 stream from L2, the E traffic and the barriers cost
  alone), each held to the plain version; ``=BASELINE.cu`` also builds
  another tree's ``bt_apply.cu`` (the same C interface) and times it in
  the same turns. Each line gives the bytes the variant streams from L2
  and their rate: ``stream_only``'s is the rate of K5's own stream.
- ``k3_levers``: K3 (``csrc/band2tridiag.cu``) at n = 8192, b = 128, f32
  on a random band, timed in turns as built and as copies of its source
  (built into ``build/dlaf_tpu_torch/k3_levers/``) patched to leave out
  the chase (``no_chase``: the chain floor, the steps and their
  hand-overs alone), the neighbour waits (``no_sync``; timing only, the
  result is wrong), the update pass (``read_only``), the read pass
  (``update_only``) or both (``load_only``: the window's bulk copies and
  the reflector), to wait for both neighbours from one thread
  (``serial_wait``) or to fence before the release store
  (``fence_and_release``), or with clock64() marks (``phases``, also
  ``load_only+phases``: block 0's time a step in each part of its step,
  one more launch). The built kernel and some variants are also timed in
  complex64 at n = 4096 (``k3_c64``: ``eigh_c64``'s shape, the streamed
  instance), and the built kernel at n = 1024, 4096 and 16384
  (``k3_sizes``). ``=A.cu[,B.cu...]`` also builds other trees'
  ``band2tridiag.cu`` and times them unpatched in the same turns
  (``baseline``, ``baseline2``, ...; the design before the neighbour
  hand-overs has no ``done`` argument). Each line gives ms, microseconds a
  wavefront step and ptxas's registers and spills.
- ``k3_loads``: ``scripts/torch_k3_loads.cu`` built and run: how fast one
  SM moves a K3 window (n = 8192, b = 128, f32) between L2 and shared
  memory, by access shape (4-byte or 16-byte loads of whole rows through
  registers, 16-byte loads of CY, S and B segments, ``cp.async.cg`` copies
  of whole rows' 16-byte chunks, one ``cp.async.bulk`` copy a row; 4-byte,
  16-byte or bulk stores), on one block and on 22 (K3's lanes at
  n = 8192).
- ``k6_levers``: K6's pipelined route (``csrc/ksub_tf32x3.cu``,
  ``ksub_tf32x3_kernel<true>``) at chip_smoke.py's (30720, 1536, 2048)
  and the n40960 cell's (38912, 512, 2048) and heaviest (38912, 2048,
  2048) chunks, timed in turns as built
  and as copies of its source (built into ``build/dlaf_tpu_torch/k6_levers/``)
  patched to leave out the promotion's adds (``no_promote``), to add a
  constant in their place (``promote_const``: the adds without reading the
  finished accumulators) or to leave out X's split (``no_split``); timing
  only, the patched sums are wrong. Each variant also runs a 3-second loop
  of launches while nvidia-smi samples the SM clock and the power draw
  (the kernel draws the card's power limit). ``=BASELINE.cu`` also times
  another tree's ``ksub_tf32x3.cu`` whose K6 entry has no route argument
  (the route before the pipelined one).
- ``stage2``: stage 2 (band to tridiagonal, through K3) as the entry
  points run it, on a random band of width 128: ``eigh``'s at n = 8192
  f32 and n = 4096 complex64 (``eigh_c64``; ``band_to_tridiag_auto`` on
  the dense band) and ``eigh_large``'s at n = 32768 f32
  (``packed_to_strips`` and one recorded chase), a warm-up and three
  timed runs each, host clock after a synchronisation.

Each probe prints JSON lines; the last line is the card's name and
power limit as nvidia-smi gives them. Runs only where a CUDA device is.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    print("torch_chip_probes: no CUDA device", file=sys.stderr)
    sys.exit(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import dlaf_tpu_torch as dt  # noqa: E402
from dlaf_tpu_torch.algos.eigensolver import bt as btm  # noqa: E402
from dlaf_tpu_torch.algos.eigensolver import large  # noqa: E402
from dlaf_tpu_torch.algos.eigensolver.band_strips import (  # noqa: E402
    band_to_strips, packed_to_strips, strips_extract_tridiag)
from dlaf_tpu_torch.matrix import generators as gen  # noqa: E402
from dlaf_tpu_torch.ops.kernels import _build  # noqa: E402
from dlaf_tpu_torch.ops.kernels.potrf import factor_deviation, potrf_tile  # noqa: E402
from dlaf_tpu_torch.ops.kernels.trailing import (  # noqa: E402
    ksub_matmul, ksub_matmul_masked_ref, ksub_matmul_ref)

DEV = torch.device("cuda", 0)
EPS32 = torch.finfo(torch.float32).eps
# (m, n, k, x_k_major): the main path's largest update, a deep level's
# split-k shape, and an NN shape
ACC_CASES = [(8192, 8192, 16384, True), (512, 512, 16384, True), (4096, 4096, 8192, False)]


def emit(probe: str, **kw) -> None:
    print(json.dumps({"probe": probe, **kw}), flush=True)


# (anchor in ksub_tf32x3.cu, the one-accumulator form); each anchor occurs once
ONE_SUM_EDITS = [
    ("tot[i] += acc[i];", "tot[i] = acc[i];"),
    ("bt_desc(bh, s), s > 0);", "bt_desc(bh, s), s > 0 || kt > 0);"),
]


def _patched_libraries(name: str, variants: dict, subdir: str, signatures=None) -> dict:
    """Each ``tag: (src, edits)`` of ``variants`` (a kernel source of
    library ``name`` with each (anchor, replacement) of ``edits`` applied),
    built into ``build/dlaf_tpu_torch/<subdir>/``, one nvcc each, all at
    once, and loaded with ``signatures`` (default: the library's own):
    {tag: (library, ptxas lines)}."""
    out = _build.BUILD_DIR / subdir
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, (src, edits) in variants.items():
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}.cu changed: anchor not found once: {old!r}")
            src = src.replace(old, new)
        path, target = out / f"{name}_{tag}.cu", out / f"lib{name}_{tag}.so"
        path.write_text(src)
        procs[tag] = (path, target, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(target), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for tag, (path, target, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {path}:\n{log}")
        lib = ctypes.CDLL(str(target))
        for fn, argtypes in (signatures or _build.SIGNATURES[name]).items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.dlaf_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dlaf_cuda_error_string.restype = ctypes.c_char_p
        libs[tag] = (lib, [line.strip() for line in log.splitlines()
                           if "registers" in line or "spill" in line])
    return libs


def _patched_library(name: str, src: str, edits, subdir: str, tag: str):
    """One variant of :func:`_patched_libraries`: (library, ptxas lines)."""
    return _patched_libraries(name, {tag: (src, edits)}, subdir)[tag]


def _one_sum_library() -> ctypes.CDLL:
    """A copy of ksub_tf32x3.cu patched to one tensor-core accumulator over
    all of k: no k step's sum starts afresh, and the second accumulator
    only takes the last value."""
    src = (_build.CSRC / "ksub_tf32x3.cu").read_text()
    return _patched_library("ksub_tf32x3", src, ONE_SUM_EDITS, "accumulation", "one_sum")[0]


def probe_accumulation() -> None:
    _build.build_all()
    one_sum = _one_sum_library()
    g = torch.Generator(device=DEV).manual_seed(2)
    for m, n, k, kmaj in ACC_CASES:
        c = gen.random_general(g, (m, n), torch.float32)
        x = gen.random_general(g, (k, m) if kmaj else (m, k), torch.float32)
        y = gen.random_general(g, (k, n), torch.float32)
        want = ksub_matmul_ref(c.double(), x.double(), y.double(), kmaj)
        bound = EPS32 * (2 * k * float(x.abs().max()) * float(y.abs().max()) + float(c.abs().max()))
        got = ksub_matmul(c.clone(), x, y, x_k_major=kmaj)
        err = float((got.double() - want).abs().max())
        got = c.clone()
        rc = one_sum.dlaf_ksub_tf32x3(got.data_ptr(), n, x.data_ptr(), x.stride(0), y.data_ptr(),
                                      n, m, n, k, int(kmaj), _build.stream_of(got))
        _build.check(rc, one_sum, "ksub_tf32x3 one-sum build")
        err_one = float((got.double() - want).abs().max())
        emit("accumulation", m=m, n=n, k=k, x_k_major=kmaj, bound=bound,
             kstep_sums_err=err, kstep_sums_of_bound=err / bound,
             one_accumulator_err=err_one, one_accumulator_of_bound=err_one / bound)
        del c, x, y, want, got


# (anchor in bt_apply.cu, replacement) per k5_levers variant
LEVER_EDITS = {
    "dense": [("constexpr bool kSkipZeros = true;", "constexpr bool kSkipZeros = false;")],
    "stream_only": [("  mma(small, al, bh[0], bh[1]);\n  mma(small, ah, bl[0], bl[1]);\n"
                     "  mma(d, ah, bh[0], bh[1]);\n", "")],
}


def _random_wy(g, nc, b):
    """(V, V2) of one group's nc chases from random exact reflectors."""
    vs = torch.randn((b, nc, b), generator=g, device=DEV)
    vs[:, :, 0] = 1.0
    return btm._group_vt_all(vs, 2.0 / (vs * vs).sum(-1), 0, b, b, nc, None)


def probe_k5_levers(baseline: str | None = None) -> None:
    from dlaf_tpu_torch.ops.kernels.bt_apply import (
        bt_apply_fused_ref, bt_apply_group_ref, bt_apply_skip_rule)
    _build.build_all()
    src = (_build.CSRC / "bt_apply.cu").read_text()
    libs = {"built": (_build.library("bt_apply"), None)}
    for tag, edits in LEVER_EDITS.items():
        libs[tag] = _patched_library("bt_apply", src, edits, "levers", tag)
    if baseline:
        libs["baseline"] = _patched_library("bt_apply", open(baseline).read(), [], "levers",
                                            "baseline")
    n, b, k, nact, v0p = 32768, 128, 8, 8, 249
    nsteps = v0p + nact - 1
    g = torch.Generator(device=DEV).manual_seed(9)
    pairs = [_random_wy(g, nsteps, b) for _ in range(k)]
    v = torch.stack([p[0] for p in pairs], 1).contiguous()
    v2 = torch.stack([p[1] for p in pairs], 1).contiguous()
    del pairs
    v2t = v2.transpose(-1, -2).contiguous()
    ep = torch.randn(((nsteps + 2) * b, n), generator=g, device=DEV)
    rule = bt_apply_skip_rule(b)
    nblocks = -(-n // 32)
    streamed = {"built": 4 * int(rule["v_loaded"].sum() + rule["v2_loaded"].sum()),
                "dense": 4 * 2 * (2 * b * b), "stream_only": 4 * int(rule["v_loaded"].sum()
                                                                  + rule["v2_loaded"].sum())}
    streamed["baseline"] = streamed["dense"]
    v4, v2t4 = v[:, 0].contiguous(), v2t[:, 0].contiguous()
    cases = {
        "K5": (sum(v0p + i for i in range(nact)), bt_apply_fused_ref, (v, v2, 0, nact, v0p, k, b),
               lambda lib, x: lib.dlaf_bt_apply_fused(x.data_ptr(), n, n, v.data_ptr(),
                                                      v2t.data_ptr(), b, k, 0, nact, v0p,
                                                      _build.stream_of(x))),
        "K4": (nsteps, bt_apply_group_ref, (v[:, 0], v2[:, 0], 0, nsteps, b),
               lambda lib, x: lib.dlaf_bt_apply_group(x.data_ptr(), n, n, v4.data_ptr(),
                                                      v2t4.data_ptr(), b, 0, nsteps,
                                                      _build.stream_of(x))),
    }
    order = list(libs) + list(reversed(libs))
    for kind, (chases, ref, args, call) in cases.items():
        want = ref(ep.clone(), *args)
        scale = float(ep.abs().max())
        times = {tag: [] for tag in libs}
        errs = {}
        x = ep.clone()
        for tag in order:
            lib = libs[tag][0]
            x.copy_(ep)
            _build.check(call(lib, x), lib, f"k5_levers {tag}")
            if tag not in errs:
                errs[tag] = float((x - want).abs().max()) / (EPS32 * scale)
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(2):
                call(lib, x)
            stop.record()
            torch.cuda.synchronize()
            times[tag].append(start.elapsed_time(stop) / 2)
        for tag in libs:
            ms = min(times[tag])
            nbytes = streamed.get(tag, streamed["built"]) * chases * nblocks
            emit("k5_levers", kernel=kind, variant=tag, chases=chases, nev=n, band=b,
                 ms=ms, ms_turns=times[tag], err_eps_of_max_e=errs[tag],
                 l2_bytes=nbytes, l2_tb_per_s=nbytes / ms / 1e9, ptxas=libs[tag][1])
        del want, x


# K3's variants: (anchor in band2tridiag.cu, replacement) lists
K3_LEVER_EDITS = {
    "no_chase": [("        if (kResident) {\n", "        if (false) {\n"),
                 ("        } else {\n          chase_streamed", "        } else if (false) {\n          chase_streamed")],
    "no_sync": [("      wait_neighbours(done, w, nlanes, t);\n", "")],
    "read_only": [("  for (int r = warp; r < 2 * b; r += kWarps) {",
                   "  for (int r = warp; false; r += kWarps) {")],
    "update_only": [("  if (g < ng && i < b) {", "  if (false) {")],
    # the neighbour wait by thread 0 alone, its two acquire loads one after
    # the other
    "serial_wait": [
        ("  if (threadIdx.x == 0 && w > 0)\n    while (ld_acquire(done + w - 1) < t) {\n    }\n"
         "  if (threadIdx.x == 32 && w + 1 < nlanes)\n",
         "  if (threadIdx.x == 0 && w > 0)\n    while (ld_acquire(done + w - 1) < t) {\n    }\n"
         "  if (threadIdx.x == 0 && w + 1 < nlanes)\n")],
    # the count published after a __threadfence() too
    "fence_and_release": [
        ("  if (threadIdx.x == 0) st_release(done + w, t + 1);",
         "  if (threadIdx.x == 0) {\n    __threadfence();\n    st_release(done + w, t + 1);\n  }")],
    # block 0 (lane 0, the first in the chain) sums clock64() between
    # marks of its thread 0 (K3_PHASES)
    "phases": [
        ("#include <stdint.h>\n",
         "#include <stdint.h>\n__device__ unsigned long long k3_acc[10], k3_last;\n"
         "#define K3_MARK(i) if (blockIdx.x == 0 && threadIdx.x == 0) { const unsigned long "
         "long now_ = clock64(); k3_acc[i] += now_ - k3_last; k3_last = now_; }\n"),
        ("  const int nsweeps = n - 2, ncmax = (n + b - 2) / b;\n",
         "  const int nsweeps = n - 2, ncmax = (n + b - 2) / b;\n"
         "  if (blockIdx.x == 0 && threadIdx.x == 0) k3_last = clock64();\n"),
        ("      wait_neighbours(done, w, nlanes, t);\n",
         "      K3_MARK(0);\n      wait_neighbours(done, w, nlanes, t);\n      K3_MARK(1);\n"),
        ("      publish(done, w, t);\n",
         "      K3_MARK(5);\n      publish(done, w, t);\n      K3_MARK(6);\n"),
        ("      *taurec = tau;\n    }\n  }\n  wait_parity(bar, parity);\n  parity ^= 1u;\n"
         "  __syncthreads();\n",
         "      *taurec = tau;\n    }\n  }\n  K3_MARK(8);\n  wait_parity(bar, parity);\n"
         "  K3_MARK(7);\n  parity ^= 1u;\n  __syncthreads();\n  K3_MARK(2);\n"),
        ("    part[(2 * ng + g) * b + i] = ap;\n  }\n  __syncthreads();\n",
         "    part[(2 * ng + g) * b + i] = ap;\n  }\n  __syncthreads();\n  K3_MARK(3);\n"),
        ("    w[g * b + i] = acc;\n  }\n  __syncthreads();\n",
         "    w[g * b + i] = acc;\n  }\n  __syncthreads();\n  K3_MARK(4);\n"),
        ("  for (int r = warp; r < 2 * b; r += kWarps) {",
         "  K3_MARK(9);\n  for (int r = warp; r < 2 * b; r += kWarps) {"),
        ('extern "C" const char* dlaf_cuda_error_string(int e) {',
         'extern "C" int dlaf_k3_marks(void* out) {\n'
         '  cudaMemcpyFromSymbol(out, k3_acc, sizeof(k3_acc));\n'
         '  unsigned long long z[10] = {0};\n'
         '  cudaMemcpyToSymbol(k3_acc, z, sizeof(z));\n'
         '  return (int)cudaGetLastError();\n}\n\n'
         'extern "C" const char* dlaf_cuda_error_string(int e) {'),
    ],
}
K3_SIZES = (1024, 4096, 16384)   # the built kernel at these n too (k3_sizes lines)
# variants built from several edit lists of K3_LEVER_EDITS, in this order
K3_COMPOSED = {"load_only": ("read_only", "update_only"),
               "load_only+phases": ("phases", "read_only", "update_only"),
               "no_chase+serial_wait": ("no_chase", "serial_wait"),
               "no_chase+fence_and_release": ("no_chase", "fence_and_release")}
K3_PHASES = ("step_loop", "wait", "barrier_after_window", "read_pass", "partial_sums",
             "update_rows_warp0", "end_barrier_fence_release", "window_landing_after_reflector",
             "y_and_reflector_warp0", "alpha_and_column_caches")
# also timed in complex64 at K3_C64
K3_C64_VARIANTS = ("built", "no_chase", "no_sync", "serial_wait", "fence_and_release",
                   "no_chase+serial_wait")
# the C interface with and without the lanes' step counts (the design before
# the neighbour handoffs had none): strips, vs, taus, [done,] n, b, nrec,
# sweep_lo, is_complex, stream; the plan's n, b, is_complex, out
K3_SIGNATURES = {
    False: {"dlaf_band2tridiag": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
            "dlaf_band2tridiag_plan": [ctypes.c_int] * 3 + [ctypes.c_void_p]},
    True: {"dlaf_band2tridiag": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
           "dlaf_band2tridiag_plan": [ctypes.c_int] * 3 + [ctypes.c_void_p]},
}
K3_C64 = (4096, 128)   # complex64 K3 at eigh_c64's (n, b): the streamed instance


def _k3_band_strips(g, n, b, dtype):
    """Strips of a random hermitian band of width ``b``."""
    a = torch.triu(gen.random_hermitian(g, n, dtype), -b)
    return band_to_strips(a, b)


def probe_k3_levers(baselines: str | None = None) -> None:
    n, b = 8192, 128
    src = (_build.CSRC / "band2tridiag.cu").read_text()
    variants = {"built": (src, [])}
    variants.update({tag: (src, edits) for tag, edits in K3_LEVER_EDITS.items()})
    variants.update({tag: (src, [e for part in parts for e in K3_LEVER_EDITS[part]])
                     for tag, parts in K3_COMPOSED.items()})
    libs = _patched_libraries("band2tridiag", variants, "k3_levers", K3_SIGNATURES[True])
    with_done = {tag: True for tag in libs}
    sources = {}
    for i, path in enumerate(baselines.split(",") if baselines else []):
        tag = "baseline" if i == 0 else f"baseline{i + 1}"
        bsrc = open(path).read()
        sources[tag], with_done[tag] = path, "void* done" in bsrc
        libs.update(_patched_libraries("band2tridiag", {tag: (bsrc, [])}, "k3_levers",
                                       K3_SIGNATURES[with_done[tag]]))
    g = torch.Generator(device=DEV).manual_seed(10)
    flags = torch.zeros(1 << 16, dtype=torch.int32, device=DEV)

    def launch(tag, work, strips, vs, taus, n, cplx=0):
        lib = libs[tag][0]
        work.copy_(strips)
        flags.zero_()
        ptrs = [work.data_ptr(), vs.data_ptr(), taus.data_ptr()]
        if with_done[tag]:
            ptrs.append(flags.data_ptr())
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        rc = lib.dlaf_band2tridiag(*ptrs, n, b, n - 2, 0, cplx, _build.stream_of(work))
        stop.record()
        _build.check(rc, lib, f"k3_levers {tag}")
        torch.cuda.synchronize()
        return start.elapsed_time(stop)

    def record(n, dtype):
        ncmax = -(-(n - 1) // b)
        return (torch.zeros((n - 1, ncmax, b), dtype=dtype, device=DEV),
                torch.zeros((n - 1, ncmax), dtype=dtype, device=DEV))

    strips = _k3_band_strips(g, n, b, torch.float32)
    work = torch.empty_like(strips)
    vs, taus = record(n, torch.float32)
    steps = 3 * (n - 3) + 1
    out = {}
    for tag in libs:   # warm-up, and each variant's d and e beside the built kernel's
        launch(tag, work, strips, vs, taus, n)
        out[tag] = strips_extract_tridiag(work, n, b)
    times = {tag: [] for tag in libs}
    for tag in list(libs) + list(reversed(libs)):
        for _ in range(2):
            times[tag].append(launch(tag, work, strips, vs, taus, n))
    for tag in [t for t in libs if "phases" in t]:   # one more launch, its clock64() sums
        lib = libs[tag][0]
        lib.dlaf_k3_marks.argtypes = [ctypes.c_void_p]
        lib.dlaf_k3_marks.restype = ctypes.c_int
        marks = (ctypes.c_ulonglong * len(K3_PHASES))()
        lib.dlaf_k3_marks(ctypes.addressof(marks))
        ms = launch(tag, work, strips, vs, taus, n)
        _build.check(lib.dlaf_k3_marks(ctypes.addressof(marks)), lib, "k3 marks")
        cycles = [marks[i] for i in range(len(K3_PHASES))]
        us_per_cycle = ms * 1e3 / sum(cycles)
        phases = {name: c / steps * us_per_cycle for name, c in zip(K3_PHASES, cycles)}
        emit("k3_phases", variant=tag, n=n, b=b, dtype="float32", ms=ms, us_per_step=phases,
             clock_ghz=1e-3 / us_per_cycle, block=0)
    for tag, (lib, ptxas) in libs.items():
        plan = (ctypes.c_int * 4)()
        _build.check(lib.dlaf_band2tridiag_plan(n, b, 0, ctypes.addressof(plan)), lib, "plan")
        d, e = out[tag]
        ms = min(times[tag])
        emit("k3_levers", variant=tag, source=sources.get(tag, "built"), n=n, b=b, dtype="float32",
             ms=ms, ms_turns=times[tag], us_per_step=ms * 1e3 / steps, wavefront_steps=steps,
             lanes=plan[0], blocks=plan[1], plan=list(plan),
             d_vs_built=float((d - out["built"][0]).abs().max()),
             abs_e_vs_built=float((e.abs() - out["built"][1].abs()).abs().max()),
             finite=bool(torch.isfinite(d).all() and torch.isfinite(e).all()), ptxas=ptxas)
    del strips, work, vs, taus, out
    # complex64 at eigh_c64's (n, b): K3_C64_VARIANTS and the baselines in turns
    n2 = K3_C64[0]
    s2 = _k3_band_strips(g, n2, b, torch.complex64)
    w2 = torch.empty_like(s2)
    v2, t2 = record(n2, torch.complex64)
    tags = list(K3_C64_VARIANTS) + list(sources)
    res = {}
    for tag in tags:
        launch(tag, w2, s2, v2, t2, n2, 1)
        res[tag] = strips_extract_tridiag(w2, n2, b)
    ms2 = {tag: [] for tag in tags}
    for tag in tags + tags[::-1] + tags + tags[::-1]:
        ms2[tag].append(launch(tag, w2, s2, v2, t2, n2, 1))
    steps2 = 3 * (n2 - 3) + 1
    for tag in tags:
        plan = (ctypes.c_int * 4)()
        lib = libs[tag][0]
        _build.check(lib.dlaf_band2tridiag_plan(n2, b, 1, ctypes.addressof(plan)), lib, "plan")
        emit("k3_c64", variant=tag, source=sources.get(tag, "built"), n=n2, b=b,
             dtype="complex64", ms=min(ms2[tag]),
             ms_turns=ms2[tag], us_per_step=min(ms2[tag]) * 1e3 / steps2,
             lanes=plan[0], blocks=plan[1], plan=list(plan),
             d_vs_built=float((res[tag][0] - res["built"][0]).abs().max()))
    del s2, w2, v2, t2
    for n3 in K3_SIZES:   # the built kernel at other n: µs a step against the strips' size
        s3 = _k3_band_strips(g, n3, b, torch.float32)
        w3 = torch.empty_like(s3)
        v3, t3 = record(n3, torch.float32)
        ms3 = [launch("built", w3, s3, v3, t3, n3) for _ in range(3)]
        emit("k3_sizes", n=n3, b=b, strips_mb=s3.numel() * 4 / 2**20, ms=min(ms3[1:]),
             us_per_step=min(ms3[1:]) * 1e3 / (3 * (n3 - 3) + 1))
        del s3, w3, v3, t3


def probe_k3_loads() -> None:
    out = _build.BUILD_DIR / "k3_loads"
    out.mkdir(parents=True, exist_ok=True)
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_k3_loads.cu")
    exe = out / "k3_loads"
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-o",
                    str(exe), src], check=True, capture_output=True, text=True)
    run = subprocess.run([str(exe)], check=True, capture_output=True, text=True, timeout=300)
    window_kb = (128 * 128 + 128 * 129 // 2 + 128 * 128) * 4 / 1024
    for line in run.stdout.splitlines():
        case, blocks, us = line.split()
        emit("k3_loads", case=case, blocks=int(blocks), us_per_window=float(us),
             window_kb=window_kb, gb_per_s=window_kb * 1024 / float(us) / 1e3)


def probe_stage2() -> None:
    from dlaf_tpu_torch.algos.eigensolver.band2tridiag import band_to_tridiag_auto
    b = 128
    for n, entry, dtype in ((8192, "eigh", torch.float32), (32768, "eigh_large", torch.float32),
                            (4096, "eigh_c64", torch.complex64)):
        g = torch.Generator(device=DEV).manual_seed(11)
        band = torch.randn((n, n), generator=g, device=DEV, dtype=dtype)
        band = torch.triu(torch.tril(band + band.mH), -b)
        if entry != "eigh_large":
            def stage2():
                return band_to_tridiag_auto(band, b)
        else:
            nsweeps = n - 2
            chunk = -(-nsweeps // b) * b

            def stage2():
                return large._chase(packed_to_strips(band, b), n, b, 0, chunk)
        secs = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = stage2()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            del out
        emit("stage2", entry=entry, n=n, b=b, dtype=str(dtype).replace("torch.", ""),
             seconds=secs[1:], warmup_seconds=secs[0])
        del band


def probe_bf16_potrf() -> None:
    n, nb = 4096, 512
    a = gen.random_hermitian_positive_definite(torch.Generator(device=DEV).manual_seed(4), n,
                                               torch.float32)
    ab = a.to(torch.bfloat16)
    for uplo in ("U", "L"):
        k1 = potrf_tile.launches
        try:
            f = dt.potrf(ab, uplo=uplo, nb=nb)
            torch.cuda.synchronize()
        except Exception as e:   # the probe reports what refuses bf16
            emit("bf16_potrf", n=n, nb=nb, uplo=uplo, runs=False,
                 error=f"{type(e).__name__}: {e}"[:400])
            continue
        want = dt.potrf(ab.float(), uplo=uplo, nb=nb)
        ff = f.float()
        prod = ff.T @ ff if uplo == "U" else ff @ ff.T
        res = float((prod - ab.float()).abs().max()) / float(ab.float().abs().max())
        emit("bf16_potrf", n=n, nb=nb, uplo=uplo, runs=True, dtype=str(f.dtype),
             k1_launches=potrf_tile.launches - k1, finite=bool(torch.isfinite(f).all()),
             residual_of_max_a=res,
             max_abs_diff_from_f32_factor=float((ff - want).abs().max()),
             max_abs_f32_factor=float(want.abs().max()),
             factor_deviation_c32_bf16=factor_deviation(f, want, 32, bf16=True))


# (anchor in ksub_tf32x3.cu, replacement) per k6_levers variant
K6_PROMOTE = "      for (int i = 16 * j; i < 16 * j + 16; ++i) tot[i] += prev[i];"
K6_LEVER_EDITS = {
    "no_promote": [(K6_PROMOTE, K6_PROMOTE.replace("tot[i] += prev[i];", "reg_fence(tot[i]);"))],
    "promote_const": [(K6_PROMOTE, K6_PROMOTE.replace("prev[i]", "1.0f"))],
    "no_split": [("for (int e = ti; e < kXBytes / 16; e += kSplitters) {",
                  "for (int e = ti; e < 0; e += kSplitters) {")],
}


def _smi_while(fn, seconds: float) -> tuple:
    """ms a call of ``fn`` in a loop of ``seconds``, and nvidia-smi's SM
    clock (MHz) and power draw (W) sampled every 0.25 s in its second half."""
    import threading
    samples, stop = [], threading.Event()

    def sample():
        time.sleep(seconds / 2)
        while not stop.is_set():
            out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                  "--format=csv,noheader,nounits"], capture_output=True,
                                 text=True, timeout=60).stdout.split(",")
            samples.append((float(out[0]), float(out[1])))
            time.sleep(0.25)

    th = threading.Thread(target=sample)
    th.start()
    t0, calls = time.perf_counter(), 0
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        calls += 20
    stop.set()
    th.join()
    return (time.perf_counter() - t0) * 1e3 / calls, samples


def probe_k6_levers(baseline: str | None = None) -> None:
    _build.build_all()
    src = (_build.CSRC / "ksub_tf32x3.cu").read_text()
    variants = {tag: (src, edits) for tag, edits in K6_LEVER_EDITS.items()}
    libs = {"built": _build.library("ksub_tf32x3")}
    libs.update({tag: lib for tag, (lib, _) in
                 _patched_libraries("ksub_tf32x3", variants, "k6_levers").items()})
    if baseline:
        _P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        sig = {"dlaf_ksub_tf32x3_masked": [_P, _LL, _P, _LL, _P, _LL, _P, _P, _I, _I, _I, _I, _P]}
        libs["baseline"] = _patched_libraries("ksub_tf32x3", {"baseline": (open(baseline).read(), [])},
                                              "k6_levers", sig)["baseline"][0]
    route = ctypes.c_int(0)
    g = torch.Generator(device=DEV).manual_seed(11)
    n = 40960
    idx = torch.arange(n, device=DEV, dtype=torch.int32)
    for m, w, k in ((30720, 1536, 2048), (38912, 512, 2048), (38912, 2048, 2048)):
        c = gen.random_general(g, (m, w), torch.float32)
        x = gen.random_general(g, (m, k), torch.float32)
        y = gen.random_general(g, (k, w), torch.float32)
        gr, gc = idx[n - m:, None].contiguous(), idx[None, n - m:n - m + w].contiguous()
        want = ksub_matmul_masked_ref(c.double(), x.double(), y.double(), gr, gc, False)
        bound = EPS32 * (2 * k * float(x.abs().max()) * float(y.abs().max()) + float(c.abs().max()))

        def call(tag, cc):
            args = [cc.data_ptr(), w, x.data_ptr(), k, y.data_ptr(), w, gr.data_ptr(),
                    gc.data_ptr(), m, w, k, 0, _build.stream_of(cc)]
            lib = libs[tag]
            _build.check(lib.dlaf_ksub_tf32x3_masked(
                *(args if tag == "baseline" else args + [ctypes.addressof(route)])), lib, tag)

        times = {tag: [] for tag in libs}
        for tag in list(libs) + list(reversed(libs)):
            cc = c.clone()
            call(tag, cc)
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(5):
                call(tag, cc)
            stop.record()
            torch.cuda.synchronize()
            times[tag].append(start.elapsed_time(stop) / 5)
        for tag in libs:
            cc = c.clone()
            call(tag, cc)
            err = float((cc.double() - want).abs().max()) / bound
            loop_ms, smi = _smi_while(lambda: call(tag, cc), 3.0)
            emit("k6_levers", variant=tag, m=m, n=w, k=k, ms=min(times[tag]),
                 ms_turns=times[tag], err_of_bound=err, loop_ms=loop_ms,
                 sm_mhz=[s[0] for s in smi], power_w=[s[1] for s in smi])
        del c, x, y, want


PROBES = {"accumulation": probe_accumulation, "bf16_potrf": probe_bf16_potrf,
          "k5_levers": probe_k5_levers, "k3_levers": probe_k3_levers, "stage2": probe_stage2,
          "k3_loads": probe_k3_loads, "k6_levers": probe_k6_levers}


if __name__ == "__main__":
    for arg in sys.argv[1:] or list(PROBES):
        name, _, value = arg.partition("=")
        PROBES[name](value) if value else PROBES[name]()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
