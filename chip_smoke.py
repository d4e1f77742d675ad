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

The eigensolver slice: K3 (stage-2 bulge chasing) against its plain
version on f32 and complex64 bands, ragged and sweep-chunked, on the bands
the main path hands it (n = 8192 f32 and 4096 complex64), and on a band
whose lanes outnumber the blocks co-resident on the card, beside planted
faults (one chase's update skipped) and with bit-identical repeats;
then ``dlaf_tpu_torch.eigh`` at n = 8192 f32, band 128 (the ``heev``
configuration of ``scripts/bench_sections.py``), timed whole and by stage
(the staged run held bit-equal to the entry point's eigenvalues),
its eigenvectors held to orthogonality and residual bounds and its
eigenvalues to ``torch.linalg.eigvalsh`` in f64 (a yardstick the port never
calls), each bound beside a planted fault; complex64 ``eigh`` at n = 4096;
and the eigensolver miniapp with ``--check`` in s and d.

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
from dlaf_tpu_torch.algos.eigensolver import band2tridiag as b2t  # noqa: E402
from dlaf_tpu_torch.algos.eigensolver import band_strips as bs  # noqa: E402
from dlaf_tpu_torch.algos.eigensolver.band2tridiag import (  # noqa: E402
    band_to_tridiag_auto, band_to_tridiag_pipelined)
from dlaf_tpu_torch.algos.eigensolver.bt import (  # noqa: E402
    bt_band_to_tridiag, bt_band_to_tridiag_sweepwise, bt_reduction_to_band)
from dlaf_tpu_torch.algos.eigensolver.driver import _phase_normalize  # noqa: E402
from dlaf_tpu_torch.algos.eigensolver.red2band import (  # noqa: E402
    extract_band, reduction_to_band)
from dlaf_tpu_torch.algos.eigensolver.tridiag_dc import tridiag_eigh  # noqa: E402
from dlaf_tpu_torch.matrix import generators as gen  # noqa: E402
from dlaf_tpu_torch.miniapps import miniapp_cholesky, miniapp_eigensolver  # noqa: E402
from dlaf_tpu_torch.ops import leaf  # noqa: E402
from dlaf_tpu_torch.ops.kernels import _build  # noqa: E402
from dlaf_tpu_torch.ops.core import symmetrize_tri  # noqa: E402
from dlaf_tpu_torch.ops.kernels.potrf import (  # noqa: E402
    factor_deviation, potrf_tile, potrf_tile_ref)
from dlaf_tpu_torch.ops.householder import householder_vector  # noqa: E402
from dlaf_tpu_torch.ops.kernels.band2tridiag import (  # noqa: E402
    band_to_tridiag_strips_kernel, band_to_tridiag_strips_ref, chase_plan)
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
# the card's published peaks (NVIDIA H100 SXM data sheet, 700 W): f32 FFMA
# rate outside the tensor cores and HBM bandwidth, for each kernel's bound
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# K3 cases on random bands: (n, b, dtype, sweep_lo, sweep_chunk); the main
# path's band width, a narrow band, b > 128, a ragged n, and a
# sweep-chunked record. Then K3 on the main path's own inputs (the bands
# stage 1 hands it in eigh_main and eigh_c64, K3_MAIN), and on a narrow band
# long enough that its lanes outnumber the blocks co-resident on the card,
# so that a block takes several lanes per wavefront step (K3_MULTI_B).
K3_CASES = [(1024, 128, torch.float32, 0, None), (1024, 128, torch.complex64, 0, None),
            (300, 16, torch.float32, 0, None), (200, 160, torch.float32, 0, None),
            (777, 32, torch.float32, 0, None), (1024, 128, torch.float32, 200, 128)]
K3_MULTI_B = 8
K3_PLAIN_TIMED = (1024, 128)    # the sequential plain version is timed where it is affordable
K3_PLANTED = (300, 16)          # the small case a planted fault is shown on
# K3's plain version is the sequential strip chase up to n = K3_SEQ_MAX;
# beyond, where that takes minutes, the batched dense chase
# band_to_tridiag_pipelined, which computes the same function
K3_SEQ_MAX = 1024
# K3 against its plain version. A tridiagonal reduction is not forward
# stable entry by entry: where a reflector's head x0 is near 0 its sign may
# go either way, which flips the signs of e and of later reflectors, and
# later entries are Lanczos coefficients, sensitive to rounding. So each
# case is held to backward errors, in units of eps32 ||B||_2, each at most
# K3_EIG (K3_RES) times the plain version's own reading on the same band
# (floor 1): the plain version sets the level the case's conditioning
# allows, and it grows with the number of chases that touch an entry (the
# plain version reads 1.3 at n = 8192, b = 128 and 16.6 at n = 4754, b = 8):
#  - eig: the eigenvalues of the tridiagonal against those of the band, f64;
#  - res: the reflector record, with Q applied from K3's own vs and taus
#    (f64), max|B Q - Q T|;
#  - rel: d and |e| (which do not see those signs) against the plain
#    version's in f64, over the plain version's own f32 distance from them,
#    that denominator clamped to [1, K3_REL_CAP] n eps32 max(1, max|A|):
#    <= K3_REL. It asks whether K3 lands as near the f64 result as the
#    plain f32 run does; the cap keeps a large inherent distance from
#    widening the bound without limit. rel is a coarse check and not a pass
#    criterion on its own: a skipped chase update at n = 8192 moves d and |e|
#    by only a few times their f32 rounding noise, and eig and res are the
#    checks that reject it;
#  - a sweep-chunked record bit-equal to the same rows of K3's full record.
# The card's readings: sound cases read eig 0.61-14.4 (0.82-1.05 times the
# plain version's), res 0.96-5.8 (0.71-1.15 times) and rel 0.08-7.5 (7.5
# where the cap binds: n = 4754, b = 8, where the plain f32 run lies 215
# n eps32 max(1, max|A|) from f64); a skipped chase update reads eig 6195 at n = 8192 (4800
# times the plain version's) and 9.0e4 at n = 300, a lost tau res 5.1e5 and
# 1.3e6.
K3_REL = 16.0
K3_REL_CAP = 100.0
K3_EIG = 4.0
K3_RES = 4.0
N_EIGH, B_EIGH, N_EIGH_C = 8192, 128, 4096
EIGH_SEED = {torch.float32: 11, torch.complex64: 12}
K3_MAIN = [(N_EIGH, torch.float32), (N_EIGH_C, torch.complex64)]
# eigh gates beside the miniapp's (orth <= 500 n eps, res <= 1000 n eps
# max|A|): orth in units of n eps, residual and eigenvalues (against
# torch.linalg.eigvalsh in f64) in units of n eps max|A|, set from the
# card's readings: sound f32 n = 8192 reads 0.014, 0.050 and 0.91, complex64
# n = 4096 0.025, 0.070 and 1.31; the planted faults read 1.15, 4157 and 54
EIGH_BOUNDS = {"orth": 0.2, "res": 1.0, "eig": 10.0}


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
    full = symmetrize_tri(a, lower=False)
    library_ms = cuda_ms(lambda: torch.linalg.cholesky_ex(full), 20)
    # nb^3/3 flops; the tile read once and the factor written once
    nb3 = NB_MAIN
    bound = {"operations": nb3**3 / 3 / PEAK_F32 * 1e3, "bytes": 2 * 4 * nb3**2 / PEAK_BYTES * 1e3}
    bound_by = max(bound, key=bound.get)
    emit("k1_nonspd", nb=nb, pivot=piv, nan_from_pivot=True)
    emit("k1_time", nb=NB_MAIN, dtype="float32", upper=True, ms=ms, plain_ms=plain_ms,
         library_ms=library_ms, bound_ms=bound[bound_by], bound_by=bound_by,
         serial_column_steps=nb3)
    KERNELS["potrf_tile"] = dict(
        name="potrf_tile", route="cuda", source="dlaf_tpu_torch/csrc/potrf_tile.cu",
        replaces="dlaf_tpu/ops/pallas/potrf.py:130", max_abs_err=worst["float32"][1],
        deviation=worst["float32"][0], max_abs_err_bf16=worst["bfloat16"][1],
        deviation_bf16=worst["bfloat16"][0], bound=K1_BOUND, ms=ms, plain_ms=plain_ms,
        bound_ms=bound[bound_by], bound_by=bound_by, library_ms=library_ms,
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
    library_ms = cuda_ms(lambda: torch.addmm(c, x.T, y, alpha=-1), 5)
    # 2mnk f32 FFMA flops; C read and written once, X and Y read once
    bound = {"operations": 2 * m * n * k / PEAK_F32 * 1e3,
             "bytes": 4 * (2 * m * n + k * m + k * n) / PEAK_BYTES * 1e3}
    bound_by = max(bound, key=bound.get)
    emit("k2_time", m=m, n=n, k=k, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
         bound_ms=bound[bound_by], bound_by=bound_by,
         tflops=2 * m * n * k / ms / 1e9, plain_tflops=2 * m * n * k / plain_ms / 1e9)
    KERNELS["ksub_matmul"] = dict(
        name="ksub_matmul", route="cuda", source="dlaf_tpu_torch/csrc/ksub.cu",
        replaces="dlaf_tpu/ops/pallas/trailing.py:109", max_abs_err=worst[0],
        bound=worst[1], ms=ms, plain_ms=plain_ms, bound_ms=bound[bound_by],
        bound_by=bound_by, library_ms=library_ms, timed_shape=[m, n, k])


def _wide(dtype):
    return torch.complex128 if dtype.is_complex else torch.float64


def _k3_band(g, n, b, dtype):
    """Strip storage of a random hermitian band matrix of bandwidth b, the
    band in f64 (complex128) with both triangles, and max|A|."""
    a = torch.triu(gen.random_hermitian(g, n, dtype), -b)   # lower band (+ unread upper)
    low = torch.tril(a).to(_wide(dtype))
    return bs.band_to_strips(a, b), low + torch.tril(low, -1).mH, float(low.abs().max())


def _eigh_input(dtype) -> torch.Tensor:
    """The matrix eigh_main (f32) or eigh_c64 (complex64) solves."""
    n = N_EIGH if dtype == torch.float32 else N_EIGH_C
    return gen.random_hermitian(torch.Generator(device=DEV).manual_seed(EIGH_SEED[dtype]), n, dtype)


def _k3_main_band(dtype):
    """K3's input on the main path: the band stage 1 makes of eigh's
    matrix, as strips, in f64 (complex128), and its max|A|."""
    packed, _ = reduction_to_band(_eigh_input(dtype), B_EIGH)
    band = extract_band(packed, B_EIGH)
    del packed
    return bs.band_to_strips(band, B_EIGH), band.to(_wide(dtype)), float(band.abs().max())


def _k3_plain(strips, band, n, b):
    """K3's plain version on ``strips``, or on the same ``band`` densely
    where n > K3_SEQ_MAX (see K3_SEQ_MAX)."""
    if n <= K3_SEQ_MAX:
        return band_to_tridiag_strips_ref(strips, n, b)
    return band_to_tridiag_pipelined(band, b)


@contextlib.contextmanager
def _planted_reflector(step: int):
    """band_to_tridiag_pipelined with lane 0's reflector at wavefront step
    ``step`` given tau = 0: that chase cleans its column but skips its
    update, a planted fault."""
    calls = [0]

    def hh(x):
        v, tau, beta = householder_vector(x)
        if calls[0] == step:
            tau = tau.clone()
            tau[0] = 0
        calls[0] += 1
        return v, tau, beta

    b2t.householder_vector = hh
    try:
        yield
    finally:
        b2t.householder_vector = householder_vector


def _k3_de_distance(got, want) -> float:
    """max |got - want| over d and |e| (invariant under the sign choices)."""
    return max(float((got[0].to(want[0].dtype) - want[0]).abs().max()),
               float((got[1].abs().to(want[1].real.dtype) - want[1].abs()).abs().max()))


def _k3_t(got):
    d, e = got[0].double(), got[1]
    e = e.to(torch.complex128) if e.is_complex() else e.double()
    return torch.diag(d).to(e.dtype) + torch.diag(e, -1) + torch.diag(e.conj(), 1)


def _k3_eig(got, ew) -> float:
    """max|eig(T) - ew| in f64, ew the band's eigenvalues, in units of
    eps32 ||B||_2."""
    return float((torch.linalg.eigvalsh(_k3_t(got)) - ew).abs().max()) / (EPS32 * float(ew.abs().max()))


def _k3_res(got, band64, n, b, bnorm) -> float:
    """max|B Q - Q T| with Q = the product of the record's reflectors, in
    f64, in units of eps32 ||B||_2. Q is applied by the sweepwise oracle up
    to n = K3_SEQ_MAX and by stage 4's grouped WY apply beyond."""
    wide = band64.dtype
    eye = torch.eye(n, dtype=wide, device=DEV)
    vs, taus = got[2].to(wide), got[3].to(wide)
    q = bt_band_to_tridiag_sweepwise(eye, vs, taus, b) if n <= K3_SEQ_MAX \
        else bt_band_to_tridiag(eye, vs, taus, b)
    del eye
    return float((band64 @ q - q @ _k3_t(got).to(wide)).abs().max()) / (EPS32 * bnorm)


def _planted_chase(strips, n, b, skip):
    """The plain chase (band_to_tridiag_strips_ref) with the update of
    chase ``skip`` = (s, c) left out: a planted fault."""
    strips = strips.clone()
    ncmax = -(-(n - 1) // b)
    vs = strips.new_zeros((n - 2, ncmax, b))
    taus = strips.new_zeros((n - 2, ncmax))
    for s in range(n - 2):
        for c in range(-(-(n - 1 - s) // b)):
            i0 = s + 1 + c * b
            g_, s3, im = bs._chase_window(strips, i0, b)
            g_new, v, tau = bs.chase_math(g_, c == 0, b)
            if (s, c) != skip:
                bs._chase_scatter(strips, g_new, s3, im, i0, b)
            vs[s, c], taus[s, c] = v, tau
    d, e = bs.strips_extract_tridiag(strips, n, b)
    return d, e, vs, taus


def _k3_bound_ms(n, b, dtype) -> tuple[float, str, dict]:
    """The least time of one K3 call at (n, b): the larger of its flops over
    the f32 peak and its bytes (strips read and written once, the record
    written once) over HBM bandwidth. A chase does ~12 b^2 real flops (two
    reductions and two rank-1 updates over CY and B, one symmetric pass and
    update of S's lower triangle); complex arithmetic four times that."""
    chases = sum(-(-(n - 1 - s) // b) for s in range(n - 2))
    cplx = dtype.is_complex
    flops = 12.0 * b * b * chases * (4 if cplx else 1)
    elem = 8 if cplx else 4
    ncmax = -(-(n - 1) // b)
    nbytes = elem * (2 * bs.n_strips(n, b) * b * bs.STRIP_W * b + (n - 1) * ncmax * (b + 1))
    ms = {"operations": flops / PEAK_F32 * 1e3, "bytes": nbytes / PEAK_BYTES * 1e3}
    by = max(ms, key=ms.get)
    return ms[by], by, {"chases": chases, "flops": flops, "bytes": nbytes,
                        "wavefront_steps": 3 * (n - 3) + 1}


def _k3_case(what, strips, band64, n, b, amax, plant=None) -> dict:
    """K3 on ``strips`` against its plain version (the checks described above K3_REL)
    and a bit-identical repeat. ``plant``, where given, makes a planted
    fault (d, e, vs, taus) that the eig check must reject; the res check is
    shown K3's own record with one tau lost. Emits its readings before it
    checks them."""
    t0 = time.perf_counter()
    dtype = strips.dtype
    got = band_to_tridiag_strips_kernel(strips, n, b)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = _k3_plain(strips, band64.to(dtype), n, b)
    stop.record()
    torch.cuda.synchronize()
    want64 = _k3_plain(strips.to(band64.dtype), band64, n, b)
    ew = torch.linalg.eigvalsh(band64)
    bnorm = float(ew.abs().max())
    floor = n * EPS32 * max(1.0, amax)
    inherent = _k3_de_distance(want, want64)
    denom = min(max(inherent, floor), K3_REL_CAP * floor)
    r = {"plain": "strips" if n <= K3_SEQ_MAX else "pipelined", "amax": amax, "norm2": bnorm,
         "plain_ms": start.elapsed_time(stop), "max_abs_err_de": _k3_de_distance(got, want),
         "plain_f32_vs_f64": inherent, "plain_f32_vs_f64_floors": inherent / floor}
    r["rel"] = _k3_de_distance(got, want64) / denom
    r["eig"], r["eig_plain"] = _k3_eig(got, ew), _k3_eig(want, ew)
    r["res"], r["res_plain"] = _k3_res(got, band64, n, b, bnorm), _k3_res(want, band64, n, b, bnorm)
    r["eig_bound"], r["res_bound"] = K3_EIG * max(1.0, r["eig_plain"]), K3_RES * max(1.0, r["res_plain"])
    r["finite"] = all(bool(torch.isfinite(x).all()) for x in got)
    again = band_to_tridiag_strips_kernel(strips, n, b)
    r["bit_identical"] = all(torch.equal(x, y) for x, y in zip(got, again))
    del again
    if plant is not None:
        bad = plant()
        r["planted_fault_rel"] = _k3_de_distance(bad, want64) / denom
        r["planted_fault_eig"] = _k3_eig(bad, ew)
        del bad
        taus = got[3].clone()
        taus[n // 2, 1] = 0                        # one recorded reflector lost
        r["planted_fault_res"] = _k3_res((*got[:3], taus), band64, n, b, bnorm)
    r["seconds"] = time.perf_counter() - t0
    emit("k3", n=n, b=b, dtype=str(dtype).replace("torch.", ""),
         bounds={"rel": K3_REL, "rel_cap": K3_REL_CAP}, **r)
    require(r["finite"], f"{what}: finite")
    for k, bound in (("rel", K3_REL), ("eig", r["eig_bound"]), ("res", r["res_bound"])):
        require(r[k] <= bound, f"{what}: {k} {r[k]} > {bound}")
    require(r["bit_identical"], f"{what}: two runs bit-identical")
    if plant is not None:
        require(r["planted_fault_eig"] > r["eig_bound"] and r["planted_fault_res"] > r["res_bound"],
                f"{what}: the checks pass a planted fault ({r})")
    return r


def phase_k3() -> None:
    """K3 against its plain version on the card, planted faults beside the
    checks, bit-identical repeats: random bands, the main path's own bands
    (K3 timed on the n = 8192 f32 one), and a band whose lanes outnumber
    the co-resident blocks."""
    g = torch.Generator(device=DEV).manual_seed(7)
    worst = {"err": 0.0, "rel": 0.0, "eig": 0.0, "res": 0.0}
    plain_ms = None

    def keep(r):
        worst["err"] = max(worst["err"], r["max_abs_err_de"])
        for k in ("rel", "eig", "res"):
            worst[k] = max(worst[k], r[k])

    for n, b, dtype, lo, chunk in K3_CASES:
        strips, band64, amax = _k3_band(g, n, b, dtype)
        what = f"K3 n={n} b={b} {dtype} sweep_lo={lo} chunk={chunk}"
        if chunk is not None:
            # the chunked record is rows [lo, lo + chunk) of the full one
            got = band_to_tridiag_strips_kernel(strips, n, b, lo, chunk)
            ref = band_to_tridiag_strips_kernel(strips, n, b)
            same = torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]) and \
                torch.equal(got[2], ref[2][lo:lo + chunk]) and torch.equal(got[3], ref[3][lo:lo + chunk])
            require(same, f"{what}: rows of the full record")
            emit("k3_chunk", n=n, b=b, dtype=str(dtype).replace("torch.", ""), sweep_lo=lo,
                 sweep_chunk=chunk, equal_to_full_record_rows=same)
            continue
        plant = None
        if (n, b, dtype) == (*K3_PLANTED, torch.float32):
            plant = lambda: _planted_chase(strips, n, b, (n // 2, 1))  # noqa: E731
        r = _k3_case(what, strips, band64, n, b, amax, plant)
        if (n, b, dtype) == (*K3_PLAIN_TIMED, torch.float32):
            plain_ms = r["plain_ms"]
        keep(r)
        del strips, band64
    # the main path's own inputs; the planted fault at n = 8192 skips the
    # update of chase (n/2, 0), in the pipelined chase's step 4 (n/2)
    b = B_EIGH
    for n, dtype in K3_MAIN:
        strips, band64, amax = _k3_main_band(dtype)
        plant = None
        if dtype == torch.float32:
            def plant():
                with _planted_reflector(4 * (n // 2)):
                    return band_to_tridiag_pipelined(band64.to(dtype), b)
            ms = cuda_ms(lambda: band_to_tridiag_strips_kernel(strips, n, b), 3)
        r = _k3_case(f"K3 main-path band n={n} b={b} {dtype}", strips, band64, n, b, amax, plant)
        if dtype == torch.float32:
            pipelined_ms = r["plain_ms"]
        keep(r)
        del strips, band64
    # a narrow band whose lanes outnumber the co-resident blocks: n such that
    # lanes = 1.5 x the grid, so half the blocks take two lanes a step
    b = K3_MULTI_B
    _, blocks = chase_plan(1 << 20, b, torch.float32)
    n = 3 * b * (blocks + blocks // 2) + 2
    lanes, grid = chase_plan(n, b, torch.float32)
    require(lanes > grid, f"K3 n={n} b={b}: {lanes} lanes fit {grid} blocks")
    strips, band64, amax = _k3_band(g, n, b, torch.float32)
    r = _k3_case(f"K3 n={n} b={b} lanes={lanes} blocks={grid}", strips, band64, n, b, amax)
    emit("k3_lanes", n=n, b=b, lanes=lanes, blocks=grid)
    keep(r)
    del strips, band64
    n, b = N_EIGH, B_EIGH
    bound_ms, bound_by, work = _k3_bound_ms(n, b, torch.float32)
    emit("k3_time", n=n, b=b, dtype="float32", ms=ms, plain_ms=plain_ms,
         plain_shape=list(K3_PLAIN_TIMED), plain_pipelined_ms=pipelined_ms,
         bound_ms=bound_ms, bound_by=bound_by, **work)
    KERNELS["band_to_tridiag_strips"] = dict(
        name="band_to_tridiag_strips", route="cuda", source="dlaf_tpu_torch/csrc/band2tridiag.cu",
        replaces="dlaf_tpu/ops/pallas/band2tridiag.py:426", max_abs_err=worst["err"],
        rel=worst["rel"], eig=worst["eig"], res=worst["res"],
        bound=f"rel <= {K3_REL}; eig, res <= {K3_EIG}, {K3_RES} x max(1, the plain "
              "version's), in eps32 ||B||_2",
        ms=ms, plain_ms=plain_ms, plain_shape=list(K3_PLAIN_TIMED),
        plain_pipelined_ms=pipelined_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, timed_shape=[n, b])


def _eigh_stages(a, b: int):
    """dlaf_tpu_torch.eigh's five stages (n % b == 0), as driver.eigh runs
    them, with a synchronization after each: (w, v, seconds per stage,
    the stage outputs the planted faults start from). A copy of the
    driver's pipeline: phase_eigh_main holds its w bit-equal to dt.eigh's."""
    tune = dt.get_tune_parameters()
    secs, out = {}, {}

    def lap(name, t0):
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return time.perf_counter()

    torch.cuda.synchronize()
    t = time.perf_counter()
    out["packed"], out["taus1"] = reduction_to_band(a, b)
    t = lap("stage1_red2band", t)
    d, e, out["vs"], out["taus2"] = band_to_tridiag_auto(extract_band(out["packed"], b), b)
    t = lap("stage2_band2tridiag", t)
    out["d"], (out["e"], out["phases"]) = d, _phase_normalize(e, a.dtype)
    w, out["q3"] = tridiag_eigh(d, out["e"], tune.laed4_max_iter)
    t = lap("stage3_tridiag_dc", t)
    v = _stage4(out, b, out["taus2"])
    t = lap("stage4_bt_band_to_tridiag", t)
    v = bt_reduction_to_band(v, out["packed"], out["taus1"], b)
    lap("stage5_bt_reduction_to_band", t)
    return w, v, secs, out


def _stage4(out, b, taus2):
    q = out["phases"][:, None] * out["q3"].to(out["packed"].dtype)
    return bt_band_to_tridiag(q, out["vs"], taus2, b,
                              group_size=dt.get_tune_parameters().bt_band_to_tridiag_hh_apply_group_size)


def _eigh_readings(a64, w, v, w64) -> dict:
    """orth in units of n eps32, residual and eigenvalue error in units of
    n eps32 max|A|, computed in f64 (complex128) on the card; plus the
    miniapp's own gate on the same (w, v)."""
    n = a64.shape[0]
    amax = float(a64.abs().max())
    v64 = v.to(a64.dtype)
    orth = float((v64.mH @ v64 - torch.eye(n, dtype=a64.dtype, device=DEV)).abs().max())
    res = float((a64 @ v64 - v64 * w.double().to(a64.dtype)[None, :]).abs().max())
    eig = float((w.double() - w64).abs().max())
    unit = n * EPS32
    return {"orth": orth / unit, "res": res / (unit * amax), "eig": eig / (unit * amax),
            "orth_abs": orth, "res_abs": res, "eig_abs": eig,
            "miniapp_gate": orth <= 500 * unit and res <= 1000 * unit * max(amax, 1.0)}


def _eigh_gates(r: dict, what: str) -> None:
    require(r["miniapp_gate"], f"{what}: the miniapp's gates ({r})")
    for k, bound in EIGH_BOUNDS.items():
        require(r[k] <= bound, f"{what}: {k} {r[k]} > {bound}")


def phase_eigh_main() -> None:
    """The eigensolver slice at full size: eigh at n = 8192 f32, band 128.
    One warm-up, two timed runs through the entry point, one staged run
    timed by stage, the gates and the planted faults they must reject."""
    n, b = N_EIGH, B_EIGH
    a = _eigh_input(torch.float32)
    a64 = a.double()
    w64 = torch.linalg.eigvalsh(a64)
    dt.eigh(a, band=b)
    band_to_tridiag_strips_kernel.launches = 0
    secs, ws_timed = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w, v = dt.eigh(a, band=b)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        ws_timed.append(w)
    launches = band_to_tridiag_strips_kernel.launches
    require(launches > 0, "eigh at n = 8192 f32 launched K3")
    KERNELS["band_to_tridiag_strips"]["launches"] = launches
    readings = _eigh_readings(a64, w, v, w64)
    _eigh_gates(readings, "eigh n=8192 f32")
    # the staged run must be the entry point's computation: the stage table
    # describes dt.eigh only while its eigenvalues equal the timed runs' bit
    # for bit
    ws, vs_, stages, out = _eigh_stages(a, b)
    same = {"w_timed_runs": torch.equal(*ws_timed), "w_staged": torch.equal(ws, w),
            "v_staged": torch.equal(vs_, v)}
    require(same["w_staged"], f"the staged eigh computes what dt.eigh computes ({same})")
    staged = _eigh_readings(a64, ws, vs_, w64)
    _eigh_gates(staged, "staged eigh n=8192 f32")
    del vs_, w, v, ws_timed
    # planted faults: each reading must exceed its bound
    planted = {}
    bad = out["taus2"].clone()
    bad[n // 2, 0] = 0                            # one stage-2 reflector dropped
    v_bad = bt_reduction_to_band(_stage4(out, b, bad), out["packed"], out["taus1"], b)
    planted["res"] = _eigh_readings(a64, ws, v_bad, w64)["res"]
    bad = out["taus1"].clone()
    bad[n // 2] *= 1.1                            # one stage-1 reflector not unitary
    v_bad = bt_reduction_to_band(_stage4(out, b, out["taus2"]), out["packed"], bad, b)
    planted["orth"] = _eigh_readings(a64, ws, v_bad, w64)["orth"]
    del v_bad
    e_bad = out["e"].clone()
    e_bad[n // 2] = 0                             # one subdiagonal entry lost
    w_bad, _ = tridiag_eigh(out["d"], e_bad, dt.get_tune_parameters().laed4_max_iter)
    planted["eig"] = float((w_bad.double() - w64).abs().max()) / (n * EPS32 * float(a64.abs().max()))
    for k, bound in EIGH_BOUNDS.items():
        require(planted[k] > bound, f"the eigh {k} check passes a planted fault ({planted[k]})")
    del out, ws, w_bad, e_bad
    torch.linalg.eigh(a)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.linalg.eigh(a)
    torch.cuda.synchronize()
    lib_s = time.perf_counter() - t0
    emit("eigh_main", n=n, band=b, dtype="float32", seconds=secs, stage_seconds=stages,
         k3_launches=launches, readings=readings, staged_readings=staged,
         bit_equal=same, bounds=EIGH_BOUNDS, planted_fault_readings=planted,
         library_ms=lib_s * 1e3, library="torch.linalg.eigh (cuSOLVER), f32")


def phase_eigh_c64() -> None:
    n = N_EIGH_C
    a = _eigh_input(torch.complex64)
    a64 = a.to(torch.complex128)
    w64 = torch.linalg.eigvalsh(a64)
    dt.eigh(a, band=B_EIGH)
    band_to_tridiag_strips_kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w, v = dt.eigh(a, band=B_EIGH)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = band_to_tridiag_strips_kernel.launches
    require(launches > 0, "eigh at n = 4096 c64 launched K3")
    readings = _eigh_readings(a64, w, v, w64)
    _eigh_gates(readings, "eigh n=4096 c64")
    emit("eigh_c64", n=n, band=B_EIGH, dtype="complex64", seconds=secs, k3_launches=launches,
         readings=readings, bounds=EIGH_BOUNDS)


def phase_miniapp_eigensolver() -> None:
    runs = {}
    for typ, n in (("s", "4096"), ("d", "1024")):
        band_to_tridiag_strips_kernel.launches = 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            miniapp_eigensolver.main(["-n", n, "--type", typ, "--check", "--nruns", "1"])
        out = buf.getvalue()
        require("check: PASSED" in out, f"miniapp_eigensolver {typ} check")
        k3 = band_to_tridiag_strips_kernel.launches
        # s runs stage 2 through K3; d through the plain strip chase
        require((k3 > 0) == (typ == "s"), f"miniapp_eigensolver {typ}: K3 launches {k3}")
        runs[typ] = {"lines": out.strip().splitlines(), "k3_launches": k3}
    emit("miniapp_eigensolver", **runs)


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
    seconds = {}
    for phase in (phase_device, phase_k1, phase_k2, phase_main, phase_miniapp, phase_info,
                  phase_k3, phase_eigh_main, phase_eigh_c64, phase_miniapp_eigensolver):
        t0 = time.perf_counter()
        phase()
        seconds[phase.__name__] = time.perf_counter() - t0
    emit("timing", seconds=seconds)
    print(smi_line())
    print(json.dumps({"kernels": [KERNELS["potrf_tile"], KERNELS["ksub_matmul"],
                                  KERNELS["band_to_tridiag_strips"]]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
