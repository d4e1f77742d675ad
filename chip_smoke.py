"""Smoke run of the PyTorch/H100 port (dlaf_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the Hopper kernels from ``dlaf_tpu_torch/csrc`` (nvcc, at first
use), holds each kernel against its plain PyTorch version at the shapes
the main path gives it, then drives the main path, the local Cholesky
``dlaf_tpu_torch.potrf`` at n = 32768 f32 (the headline configuration of
``bench.py``), through the kernels and through the plain route, and checks
the factor's residual and the kernel route's factor against the plain
route's, entry by entry. Each factor check is also shown a planted fault
(one slab update skipped), which it must reject. Then the Cholesky miniapp with ``--check``, and
``potrf_info`` on a matrix that is not positive definite.

Every phase prints one JSON line. Any failed check raises, so the exit code
is not 0; nothing catches it. The last lines are the card's
``nvidia-smi`` name and power limit, one JSON line with the kernels, and
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
with code 1 before it prints any result.
"""
from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
    sys.exit(1)

import dlaf_tpu_torch as dt  # noqa: E402
from dlaf_tpu_torch.matrix import generators as gen  # noqa: E402
from dlaf_tpu_torch.miniapps import miniapp_cholesky  # noqa: E402
from dlaf_tpu_torch.ops import leaf  # noqa: E402
from dlaf_tpu_torch.ops.kernels import _build  # noqa: E402
from dlaf_tpu_torch.ops.core import symmetrize_tri  # noqa: E402
from dlaf_tpu_torch.ops.kernels.potrf import (  # noqa: E402
    factor_deviation, potrf_tile, potrf_tile_ref)
from dlaf_tpu_torch.ops.kernels.trailing import ksub_matmul, ksub_matmul_ref  # noqa: E402
from dlaf_tpu_torch.types import eps  # noqa: E402

DEV = torch.device("cuda", 0)
N_MAIN, NB_MAIN = 32768, 512
EPS32 = eps(torch.float32)
K1_NBS = (64, 128, 256, 512)           # leaf sizes of the main path and the bench
# Factor checks, per entry (factor_deviation <= 1): |got - want| <= C eps32
# (|want| + max off-diagonal |want|), plus half a bf16 ulp for bf16. On an
# H100, sound f32 factors read at most 3.5 in units of eps32 (|want| + max
# off-diagonal |want|): K1 against cholesky_ex at nb = 64..512, and the
# kernel route's n = 32768 factor against the plain route's (3.3). One
# skipped slab update reads 1.1e3 times K1's bound or more, and, in one
# leaf of the n = 32768 POTRF, 760 in those units (47 times ROUTE_C's
# bound). Every K1 case and the full-size POTRF are checked beside such a
# planted fault, which the check must reject.
K1_C, ROUTE_C = 32, 16
K1_BOUND = f"|got-want| <= {K1_C} eps32 (|want| + max offdiag |want|) [+ bf16 ulp/2]"
# the residual's second bound: max|U^T U - A| <= RES_K eps32 max|A| (sound
# runs read 3.0 at n = 32768; a "factor" that is only the square root of
# the diagonal reads about 256 there)
RES_K = 16
# (m, n, k, x_k_major, leading-dimension pad): main-path trailing shapes,
# both layouts, and ragged row-strided views that are not 16-byte aligned
# (512-wide blocks and the 300 x 200 case take the cluster split of k)
K2_CASES = [(512, 512, 512, True, 0), (512, 512, 16384, True, 0),
            (4096, 4096, 8192, True, 0), (8192, 8192, 16384, True, 0),
            (8192, 8192, 16384, False, 0), (1000, 777, 1234, True, 3),
            (1000, 777, 1234, False, 5), (300, 200, 5000, False, 2)]
K2_TIMED = (8192, 8192, 16384)          # the largest trailing update at n = 32768
GEMM_N = 16384
MINIAPP_N = "8192"
KERNELS = {}   # name -> the entry of the kernels line


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` on the card, by CUDA events, after one warm-up."""
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def phase_device() -> None:
    t0 = time.perf_counter()
    log = _build.build_all()
    emit("device", kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi_line(), torch=torch.__version__, cuda=torch.version.cuda,
         build_seconds=round(time.perf_counter() - t0, 3), build=log)


def _spd_tile(g, nb, dtype, upper):
    """SPD tile with large garbage in the triangle the factor must not read."""
    a = gen.random_hermitian_positive_definite(g, nb, torch.float32)
    junk = 1e3 * gen.random_general(g, (nb, nb), torch.float32)
    ones = torch.ones_like(a, dtype=torch.bool)
    return torch.where(ones.triu() if upper else ones.tril(), a, junk).to(dtype)


def _planted(a, upper, skip):
    """A planted fault: the f64 factor of ``a`` (its ``upper`` or lower
    triangle) by 32-row slabs, as K1 computes it, with slab ``skip``'s
    rank-32 trailing update left out; rounded to a's dtype."""
    w = symmetrize_tri(a.double(), lower=not upper)
    u = torch.zeros_like(w)
    for s, k0 in enumerate(range(0, w.shape[0], 32)):
        k1 = k0 + 32
        ukk = torch.linalg.cholesky(w[k0:k1, k0:k1]).mT
        u[k0:k1, k0:k1] = ukk
        u[k0:k1, k1:] = torch.linalg.solve_triangular(ukk.mT, w[k0:k1, k1:], upper=False)
        if s != skip:
            w[k1:, k1:] -= u[k0:k1, k1:].mT @ u[k0:k1, k1:]
    u = u.to(a.dtype)
    return u if upper else u.mT.contiguous()


def _k1_case(a, nb, upper, dtype, view):
    """K1 on ``a`` against its plain version, and the same check against a
    planted fault (the last slab update but one skipped), which it must
    reject."""
    bf16 = dtype == torch.bfloat16
    got = potrf_tile(a, upper=upper)
    # bf16: the f32 factor of the same bf16 input, which K1 rounds once
    want = potrf_tile_ref(a.float() if bf16 else a, upper=upper)
    dev = factor_deviation(got, want, K1_C, bf16=bf16)
    planted = factor_deviation(_planted(a, upper, nb // 32 - 2), want, K1_C, bf16=bf16)
    err = float((got.float() - want).abs().max())
    other = torch.tril(got, -1) if upper else torch.triu(got, 1)
    what = f"K1 nb={nb} upper={upper} {dtype} view={view}"
    require(bool(torch.isfinite(got).all()), f"{what}: finite")
    require(dev <= 1.0, f"{what}: deviation {dev} > 1")
    require(planted > 1.0, f"{what}: the check passes a planted fault ({planted})")
    require(float(other.abs().max()) == 0.0, f"{what}: other triangle zero")
    key = str(dtype).replace("torch.", "")
    emit("k1", nb=nb, upper=upper, dtype=key, lda=a.stride(0), max_abs_err=err,
         deviation=dev, planted_fault_deviation=planted, bound=1.0)
    return key, err, dev


def phase_k1() -> None:
    """K1 against its plain version: nb 64..512, upper and lower, f32 and
    bf16, and nb = 512 views with the main path's leading dimension."""
    g = torch.Generator(device=DEV).manual_seed(1)
    worst = {}
    cases = [(_spd_tile(g, nb, dtype, upper), nb, upper, dtype, False)
             for nb in K1_NBS for upper in (True, False)
             for dtype in (torch.float32, torch.bfloat16)]
    bufs = []
    for upper in (True, False):
        # the leaf as potrf_upper/potrf_lower pass it: a view into the
        # (n, n) buffer, leading dimension n = 32768; the kernel must not
        # write into it
        nb = NB_MAIN
        buf = 1e3 * gen.random_general(g, (2 * nb, N_MAIN), torch.float32)
        j0 = N_MAIN // 4
        view = buf[nb:, j0:j0 + nb]
        view.copy_(_spd_tile(g, nb, torch.float32, upper))
        bufs.append((buf, buf.clone()))
        cases.append((view, nb, upper, torch.float32, True))
    for a, nb, upper, dtype, view in cases:
        key, err, dev = _k1_case(a, nb, upper, dtype, view)
        worst[key] = max(worst.get(key, (0.0, 0.0)), (dev, err))
    require(all(torch.equal(b, b0) for b, b0 in bufs), "K1 left its input view unchanged")
    del cases, bufs
    # a non-positive pivot gives NaN from there on, no trap
    nb, piv = 256, 100
    a = gen.random_hermitian_positive_definite(g, nb, torch.float32)
    a[piv, piv] = -1.0
    d = potrf_tile(a, upper=True).diagonal()
    torch.cuda.synchronize()
    require(bool(torch.isfinite(d[:piv]).all()) and bool(torch.isnan(d[piv:]).all()),
            "K1 non-SPD tile: NaN from the failing pivot on")
    a = _spd_tile(g, NB_MAIN, torch.float32, True)
    ms = cuda_ms(lambda: potrf_tile(a, upper=True), 20)
    plain_ms = cuda_ms(lambda: potrf_tile_ref(a, upper=True), 20)
    emit("k1_nonspd", nb=nb, pivot=piv, nan_from_pivot=True)
    emit("k1_time", nb=NB_MAIN, dtype="float32", upper=True, ms=ms, plain_ms=plain_ms)
    KERNELS["potrf_tile"] = dict(
        name="potrf_tile", route="cuda", source="dlaf_tpu_torch/csrc/potrf_tile.cu",
        replaces="dlaf_tpu/ops/pallas/potrf.py:130", max_abs_err=worst["float32"][1],
        deviation=worst["float32"][0], max_abs_err_bf16=worst["bfloat16"][1],
        deviation_bf16=worst["bfloat16"][0], bound=K1_BOUND, ms=ms, plain_ms=plain_ms,
        timed_shape=[NB_MAIN, NB_MAIN])


def _strided(g, rows, cols, pad):
    """(rows, cols) f32 view with leading dimension cols + pad and an offset."""
    buf = gen.random_general(g, (rows, cols + pad), torch.float32)
    return buf[:, pad:] if pad else buf


def phase_k2() -> None:
    """K2 against its plain version computed in f64: main-path shapes, both
    layouts, and a ragged shape of row-strided, unaligned views."""
    g = torch.Generator(device=DEV).manual_seed(2)
    worst = (0.0, 0.0)
    for m, n, k, kmaj, pad in K2_CASES:
        c = _strided(g, m, n, pad)
        x = _strided(g, k, m, pad) if kmaj else _strided(g, m, k, pad)
        y = _strided(g, k, n, pad)
        want = ksub_matmul_ref(c.double(), x.double(), y.double(), kmaj)
        out = _strided(g, m, n, pad)
        out.copy_(c)
        got = ksub_matmul(out, x, y, x_k_major=kmaj)
        plain = ksub_matmul_ref(c, x, y, kmaj)
        # one f32 accumulator per output walks all k terms: its rounding
        # error grows like eps k max|x| max|y| (measured: 0.8 of that at
        # k = 16384); TF32's 10-bit products land far above 2x that, and
        # the TF32 error is measured below on the largest shape to show it
        bound = EPS32 * (2 * k * float(x.abs().max()) * float(y.abs().max())
                         + float(c.abs().max()))
        err = float((got.double() - want).abs().max())
        plain_err = float((plain.double() - want).abs().max())
        require(err <= bound, f"K2 {(m, n, k, kmaj)}: {err} > {bound}")
        worst = max(worst, (err, bound))
        extra = {}
        if (m, n, k) == K2_TIMED:
            torch.backends.cuda.matmul.allow_tf32 = True
            tf32 = ksub_matmul_ref(c, x, y, kmaj)
            torch.backends.cuda.matmul.allow_tf32 = False
            extra["tf32_err"] = float((tf32.double() - want).abs().max())
            del tf32
        emit("k2", m=m, n=n, k=k, x_k_major=kmaj, ld_pad=pad, max_abs_err=err,
             plain_f32_err=plain_err, bound=bound, **extra)
        del c, x, y, want, out, got, plain
    m, n, k = K2_TIMED
    c, x, y = (gen.random_general(g, s, torch.float32) for s in ((m, n), (k, m), (k, n)))
    ms = cuda_ms(lambda: ksub_matmul(c, x, y), 5)
    plain_ms = cuda_ms(lambda: ksub_matmul_ref(c, x, y), 5)
    emit("k2_time", m=m, n=n, k=k, ms=ms, plain_ms=plain_ms,
         tflops=2 * m * n * k / ms / 1e9, plain_tflops=2 * m * n * k / plain_ms / 1e9)
    KERNELS["ksub_matmul"] = dict(
        name="ksub_matmul", route="cuda", source="dlaf_tpu_torch/csrc/ksub.cu",
        replaces="dlaf_tpu/ops/pallas/trailing.py:109", max_abs_err=worst[0],
        bound=worst[1], ms=ms, plain_ms=plain_ms, timed_shape=[m, n, k])


def _timed_potrf(a) -> tuple[float, torch.Tensor]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f = dt.potrf(a, uplo="U", nb=NB_MAIN, clean=False)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, f


def _residual(f, a) -> float:
    """max|U^T U - A|, in place on the factor (leaves triu(f) in f)."""
    u = f.triu_()
    r = u.T @ u
    return float(r.sub_(a).abs_().max())


def _set_route(route: str) -> None:
    leaf.set_leaf_backend(None if route == "kernel" else "torch")
    dt.set_tune_parameters(potrf_trailing_kernel=route)


@contextlib.contextmanager
def _planted_leaf(which: int):
    """Plain-route leaves, with leaf number ``which`` a planted fault."""
    calls = [0]

    def plain(t, upper=False):
        calls[0] += 1
        if calls[0] - 1 == which:
            return _planted(t, upper, t.shape[0] // 32 - 2)
        return potrf_tile_ref(t, upper)

    leaf.potrf_tile_ref = plain
    try:
        yield
    finally:
        leaf.potrf_tile_ref = potrf_tile_ref


def phase_main() -> None:
    """The slice at full size: upper POTRF at n = 32768 f32, nb = 512, in
    turns through the kernels and through the plain route. The kernel
    route's factor is held entry by entry to the plain route's, and so is
    a plain-route factor with one planted leaf fault, which must fail."""
    n = N_MAIN
    flops = n**3 / 3
    t0 = time.perf_counter()
    a = gen.random_hermitian_positive_definite(
        torch.Generator(device=DEV).manual_seed(0), n, torch.float32)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    bound = 100 * n * EPS32
    amax = float(a.abs().max())
    secs = {"kernel": [], "torch": []}
    res, res_k, dev = {}, {}, {}
    plain = None
    potrf_tile.launches = ksub_matmul.launches = 0
    for i, route in enumerate(["kernel", "torch", "torch", "kernel", "kernel", "torch"]):
        _set_route(route)
        before = (potrf_tile.launches, ksub_matmul.launches)
        t, f = _timed_potrf(a)
        if route == "torch":
            require((potrf_tile.launches, ksub_matmul.launches) == before,
                    "the plain route launched a kernel")
        if i >= 2:   # runs 0 and 1 are the warm-ups of each route
            secs[route].append(t)
        if route not in res and i >= 2:
            r = _residual(f, a)
            res[route], res_k[route] = r / n, r / (EPS32 * amax)
            require(res[route] <= bound, f"POTRF {route} residual {res[route]} > {bound}")
            require(res_k[route] <= RES_K, f"POTRF {route} residual {res_k[route]} "
                    f"eps max|A| > {RES_K}")
            if route == "torch":
                plain = f
            else:
                dev["kernel"] = factor_deviation(f, plain, ROUTE_C)
                require(dev["kernel"] <= 1.0, f"POTRF kernel route factor deviates "
                        f"from the plain route's: {dev['kernel']} > 1")
        del f
    launches = {"potrf_tile": potrf_tile.launches, "ksub_matmul": ksub_matmul.launches}
    require(launches["potrf_tile"] > 0 and launches["ksub_matmul"] > 0,
            f"main path launched every kernel: {launches}")
    for k, v in launches.items():
        KERNELS[k]["launches"] = v
    _set_route("torch")
    with _planted_leaf(n // NB_MAIN // 2):
        _, f = _timed_potrf(a)
    dev["planted_leaf"] = factor_deviation(f.triu_(), plain, ROUTE_C)
    require(dev["planted_leaf"] > 1.0, "the route check passes a planted leaf fault "
            f"({dev['planted_leaf']})")
    leaf.set_leaf_backend(None)
    dt.reset_tune_parameters()
    del a, f, plain
    torch.cuda.empty_cache()
    ng = GEMM_N
    b = gen.random_general(torch.Generator(device=DEV).manual_seed(3), (ng, ng), torch.float32)
    gemm_ms = cuda_ms(lambda: b @ b, 3)
    del b
    best = {r: min(v) for r, v in secs.items()}
    emit("potrf_main", n=n, nb=NB_MAIN, uplo="U", dtype="float32", clean=False,
         gen_seconds=gen_s, seconds=secs,
         tflops={r: flops / t / 1e12 for r, t in best.items()},
         residual=res, residual_bound=bound, residual_eps_max_a=res_k,
         residual_eps_max_a_bound=RES_K, factor_deviation=dev,
         factor_bound=f"|U_kernel-U_torch| <= {ROUTE_C} eps32 (|U_torch| + max offdiag)",
         launches=launches, gemm_f32_n=ng, gemm_f32_tflops=2 * ng**3 / gemm_ms / 1e9,
         allow_tf32=torch.backends.cuda.matmul.allow_tf32)


def _miniapp(argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        miniapp_cholesky.main(argv)
    return buf.getvalue()


def phase_miniapp() -> None:
    potrf_tile.launches = 0
    out = _miniapp(["-n", MINIAPP_N, "-b", "256", "--uplo", "L", "--check", "--nruns", "1"])
    require("check: PASSED" in out, "miniapp f32 check")
    k1 = potrf_tile.launches
    require(k1 > 0, "miniapp f32 ran K1")
    out_d = _miniapp(["-n", MINIAPP_N, "-b", "256", "--type", "d", "--check", "--nruns", "1"])
    require("check: PASSED" in out_d, "miniapp f64 check")
    emit("miniapp", s=out.strip().splitlines(), d=out_d.strip().splitlines(), k1_launches=k1)


def phase_info() -> None:
    n, nb, bad = 4096, 512, 2500
    a = gen.random_hermitian_positive_definite(
        torch.Generator(device=DEV).manual_seed(5), n, torch.float32)
    _, info_ok = dt.potrf_info(a, uplo="U", nb=nb)
    a[bad, bad] = -1.0
    got = {}
    for uplo in ("U", "L"):
        _, info = dt.potrf_info(a, uplo=uplo, nb=nb)
        got[uplo] = int(info)
        tile = bad // nb
        require(tile * nb < got[uplo] <= (tile + 1) * nb,
                f"potrf_info {uplo}: info {got[uplo]} outside the failing tile")
    require(int(info_ok) == 0, "potrf_info on an SPD matrix")
    emit("potrf_info", n=n, nb=nb, bad_index=bad, info=got, info_spd=int(info_ok))


def main() -> None:
    phase_device()
    phase_k1()
    phase_k2()
    phase_main()
    phase_miniapp()
    phase_info()
    print(smi_line())
    print(json.dumps({"kernels": [KERNELS["potrf_tile"], KERNELS["ksub_matmul"]]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
