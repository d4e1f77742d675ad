"""Measurements of the PyTorch/H100 port beside chip_smoke.py's checks, on one CUDA card.

    python3 scripts/torch_chip_probes.py accumulation bf16_potrf profile dist_profile \
        stage4_profile k5_levers[=BASELINE.cu]

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
- ``profile``: ``torch.profiler`` over one POTRF U at n = 32768 f32,
  nb = 512, clean=False (chip_smoke.py's main path) on each route after a
  warm-up: the device-busy total (the kernels' and copies' own device
  time), each kernel's time and launches, and the idle share of the wall
  time of an unprofiled run of the same call.
- ``dist_profile``: the same over one distributed ``cholesky`` on a 1x1
  ``Grid`` at n = 32768 f32, nb = 512 (chip_smoke.py's ``dist_main``), L
  and U, each route: besides the device-busy total, the idle share and the
  largest device items, K6's total device time and launches (every
  ``ksub`` kernel on this path is K6's) beside the wrapper's count.
- ``stage4_profile``: the same over one stage 4 of ``eigh_large`` at
  n = 32768 f32, band 128 (chip_smoke.py's ``eigh_large_main`` matrix,
  seed 13): stages 1 and 2 make the reflector record, and
  ``bt_band_to_tridiag(shifted=True)`` applies it to a random shifted
  buffer of the same shape (the kernels' time does not depend on the
  values). Besides the device-busy total and the idle share: the K4/K5
  kernel's device ms and launches (both wrappers launch one kernel
  function; the wrappers' counts say which), the rest of the device time
  (the slab building: ``bt._group_vt_all`` with ``t_factor``, the slabs'
  zero fills and copies), and the wall time of the same stage 4 with the
  K4/K5 launches left out (what the slab building alone takes, host and
  device).
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
from dlaf_tpu_torch.algos.eigensolver.band_strips import packed_to_strips  # noqa: E402
from dlaf_tpu_torch.algos.eigensolver.red2band import reduction_to_band  # noqa: E402
from dlaf_tpu_torch.matrix import generators as gen  # noqa: E402
from dlaf_tpu_torch.ops import leaf  # noqa: E402
from dlaf_tpu_torch.ops.kernels import _build  # noqa: E402
from dlaf_tpu_torch.ops.kernels.potrf import factor_deviation, potrf_tile  # noqa: E402
from dlaf_tpu_torch.ops.kernels.bt_apply import bt_apply_fused, bt_apply_group  # noqa: E402
from dlaf_tpu_torch.ops.kernels.trailing import (  # noqa: E402
    ksub_matmul, ksub_matmul_masked, ksub_matmul_ref)

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


def _patched_library(name: str, src: str, edits, subdir: str, tag: str):
    """``src`` (a kernel source of library ``name``) with each (anchor,
    replacement) of ``edits`` applied, built into
    ``build/dlaf_tpu_torch/<subdir>/`` and loaded: (library, ptxas lines)."""
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}.cu changed: anchor not found once: {old!r}")
        src = src.replace(old, new)
    out = _build.BUILD_DIR / subdir
    out.mkdir(parents=True, exist_ok=True)
    path, target = out / f"{name}_{tag}.cu", out / f"lib{name}_{tag}.so"
    path.write_text(src)
    run = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(target), str(path)],
                         capture_output=True, text=True)
    if run.returncode:
        raise RuntimeError(f"nvcc failed for {path}:\n{run.stdout}{run.stderr}")
    lib = ctypes.CDLL(str(target))
    for fn, argtypes in _build.SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.dlaf_cuda_error_string.argtypes = [ctypes.c_int]
    lib.dlaf_cuda_error_string.restype = ctypes.c_char_p
    ptxas = [line.strip() for line in (run.stdout + run.stderr).splitlines()
             if "registers" in line or "spill" in line]
    return lib, ptxas


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


def _device_us(evt) -> float:
    """A device event's own time (a host op's device time is its kernels')."""
    from torch.autograd import DeviceType
    if evt.device_type != DeviceType.CUDA:
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _set_route(route: str) -> None:
    leaf.set_leaf_backend(None if route == "kernel" else "torch")
    dt.set_tune_parameters(potrf_trailing_kernel=route)


def _profiled(call) -> dict:
    """``call`` once to warm up, once timed unprofiled, once under
    ``torch.profiler``: wall times, the device-busy total (the kernels' and
    copies' own device time), the idle share of the unprofiled wall time,
    and the device items by name, largest first."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_profiled = time.perf_counter() - t0
    avgs = prof.key_averages()
    rows = [(e.key, _device_us(e), e.count) for e in avgs]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows) / 1e3
    return {"wall_ms": wall * 1e3, "wall_profiled_ms": wall_profiled * 1e3,
            "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / (wall * 1e3), "rows": rows}


def _top(rows, busy_ms, count=14) -> list:
    return [{"name": r[0][:120], "ms": r[1] / 1e3, "launches": r[2], "share": r[1] / 1e3 / busy_ms}
            for r in rows[:count]]


def probe_profile() -> None:
    n, nb = 32768, 512
    a = gen.random_hermitian_positive_definite(torch.Generator(device=DEV).manual_seed(0), n,
                                               torch.float32)
    for route in ("kernel", "torch"):
        _set_route(route)
        r = _profiled(lambda: dt.potrf(a, uplo="U", nb=nb, clean=False))
        rows = r.pop("rows")
        emit("profile", route=route, n=n, nb=nb, uplo="U", **r,
             kernels=_top(rows, r["device_busy_ms"]))
    leaf.set_leaf_backend(None)
    dt.reset_tune_parameters()


def probe_dist_profile() -> None:
    n, nb = 32768, 512
    a = gen.random_hermitian_positive_definite(torch.Generator(device=DEV).manual_seed(0), n,
                                               torch.float32)
    dm = dt.DistMatrix.from_global(a, nb, dt.Grid((1, 1)))
    for uplo in ("L", "U"):
        for route in ("kernel", "torch"):
            _set_route(route)
            before = ksub_matmul_masked.launches
            r = _profiled(lambda: dt.cholesky(dm, uplo=uplo))
            rows = r.pop("rows")
            k6 = [x for x in rows if "ksub" in x[0]]
            emit("dist_profile", route=route, n=n, nb=nb, uplo=uplo, grid=[1, 1], **r,
                 k6_ms=sum(x[1] for x in k6) / 1e3, k6_launches=sum(x[2] for x in k6),
                 k6_wrapper_launches=(ksub_matmul_masked.launches - before) // 3,
                 k6_share=sum(x[1] for x in k6) / 1e3 / r["device_busy_ms"],
                 kernels=_top(rows, r["device_busy_ms"]))
    leaf.set_leaf_backend(None)
    dt.reset_tune_parameters()


def probe_stage4_profile() -> None:
    n, b = 32768, 128
    a = gen.random_hermitian(torch.Generator(device=DEV).manual_seed(13), n, torch.float32)
    packed, _ = reduction_to_band(a, b)
    del a
    strips = packed_to_strips(packed, b)
    del packed
    _, _, vs, taus = large._chase(strips, n, b, 0, -(-(n - 2) // b) * b)
    del strips
    ep2 = torch.randn((n + 2 * b, n), generator=torch.Generator(device=DEV).manual_seed(14),
                      device=DEV)
    ep2[n - 1:].zero_()
    def stage4():
        btm.bt_band_to_tridiag(ep2, vs, taus, b, group_size=b, shifted=True)

    bt_apply_group.launches = bt_apply_fused.launches = 0
    r = _profiled(stage4)
    k4, k5 = bt_apply_group.launches // 3, bt_apply_fused.launches // 3
    # the same stage 4 with the K4/K5 launches left out: what the slab
    # building alone takes, host and device
    kernels = btm.bt_apply_group, btm.bt_apply_fused
    btm.bt_apply_group = btm.bt_apply_fused = lambda ep, *args: ep
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stage4()
        torch.cuda.synchronize()
        slab_only_ms = (time.perf_counter() - t0) * 1e3
    finally:
        btm.bt_apply_group, btm.bt_apply_fused = kernels
    rows = r.pop("rows")
    kern = [x for x in rows if "bt_apply" in x[0]]
    kern_ms = sum(x[1] for x in kern) / 1e3
    emit("stage4_profile", n=n, band=b, **r, kernel_ms=kern_ms,
         kernel_launches=sum(x[2] for x in kern), k4_wrapper_launches=k4,
         k5_wrapper_launches=k5, kernel_share=kern_ms / r["device_busy_ms"],
         rest_device_ms=r["device_busy_ms"] - kern_ms, slab_only_wall_ms=slab_only_ms,
         kernels=_top(rows, r["device_busy_ms"]))


PROBES = {"accumulation": probe_accumulation, "bf16_potrf": probe_bf16_potrf,
          "profile": probe_profile, "dist_profile": probe_dist_profile,
          "stage4_profile": probe_stage4_profile, "k5_levers": probe_k5_levers}


if __name__ == "__main__":
    for arg in sys.argv[1:] or list(PROBES):
        name, _, value = arg.partition("=")
        PROBES[name](value) if value else PROBES[name]()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
