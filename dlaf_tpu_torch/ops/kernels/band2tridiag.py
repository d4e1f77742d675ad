"""K3: stage-2 wavefront bulge chasing on strip storage — hand-written
Hopper kernel.

Replaces the Pallas kernel ``dlaf_tpu/ops/pallas/band2tridiag.py``
``band_to_tridiag_strips_pallas`` (``_make_kernel``). The CUDA source is
``dlaf_tpu_torch/csrc/band2tridiag.cu``: one persistent cooperative launch
walks the ~3n wavefront steps, a block per concurrent chase (a lane); its
header says what bounds it and how the design answers. The launcher picks
one of two instances of the chase from (dtype, b) before the launch:
``resident`` keeps the chase's window in shared memory where it fits,
``streamed`` reads it from L2 where it does not (:func:`chase_instance`
mirrors the rule).

:func:`band_to_tridiag_strips_kernel` dispatches on the tensor's device: a
CPU tensor takes the plain version :func:`band_to_tridiag_strips_ref` (the
sequential chase of :mod:`dlaf_tpu_torch.algos.eigensolver.band_strips`);
a CUDA tensor launches the kernel or raises. There is no fallback from one
to the other.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ...algos.eigensolver.band_strips import (STRIP_W, band_to_tridiag_strips,
                                             n_strips, strips_extract_tridiag)
from . import _build

KERNEL_DTYPES = (torch.float32, torch.complex64)
MIN_BAND = 8
# csrc/band2tridiag.cu kMaxB: the streamed instance's row pointers, five
# length-b vectors and four partial-sum tables in shared memory stay under
# 227 KB in complex64
MAX_BAND = 384
# csrc/band2tridiag.cu: threads a block, the resident instance's widest
# band, and the header of its shared memory
KERNEL_THREADS = 512
RESIDENT_MAX_BAND = 128
SMEM_HEADER = 64

band_to_tridiag_strips_ref = band_to_tridiag_strips


def chaser_feasible(b: int, dtype) -> bool:
    """Whether the kernel takes band ``b`` in ``dtype``: f32 or complex64,
    and 8 <= b <= 384 (the streamed instance's shared-memory plan). The
    launch sizes its grid to the blocks that fit on the card, so there is
    no co-residency condition on n."""
    return dtype in KERNEL_DTYPES and MIN_BAND <= b <= MAX_BAND


def _row_floats(entries: int, floats: int) -> int:
    return (entries * floats + 9) // 4 * 4    # csrc row_floats


def resident_smem_bytes(b: int, dtype) -> int:
    """Shared memory of the resident instance at band ``b`` (csrc
    ``resident_bytes``): the header, b rows [CY | S] and b rows B (each
    after a shift of up to 3 floats, with a 16-byte chunk's overhang, in
    whole chunks), v, w, q, p, and the read pass's partial sums."""
    floats = 2 if dtype.is_complex else 1
    groups = KERNEL_THREADS // (-(-b // 32) * 32)
    return (SMEM_HEADER + b * (_row_floats(2 * b, floats) + _row_floats(b, floats)) * 4
            + (4 * b + 3 * groups * b) * 4 * floats)


def device_smem_optin(device=None) -> int:
    """The shared memory a block may opt in to on a CUDA device
    (cudaDevAttrMaxSharedMemoryPerBlockOptin, which the launcher reads)."""
    return torch.cuda.get_device_properties(device).shared_memory_per_block_optin


def chase_instance(b: int, dtype, smem_optin: int) -> str:
    """The instance the launcher picks at (b, dtype) on a device whose
    blocks may opt in to ``smem_optin`` bytes of shared memory
    (:func:`device_smem_optin`): "resident" where b <= 128, a row of b
    entries is a whole number of 16-byte chunks (b % 4 == 0 in f32,
    b % 2 == 0 in complex64), and the window fits (on an H100: f32 up to
    b = 128, complex64 up to b = 94), else "streamed"."""
    floats = 2 if dtype.is_complex else 1
    fits = (b <= RESIDENT_MAX_BAND and b * floats % 4 == 0
            and resident_smem_bytes(b, dtype) <= smem_optin)
    return "resident" if fits else "streamed"


def band_to_tridiag_strips_kernel(strips: torch.Tensor, n: int, b: int, sweep_lo: int = 0,
                                  sweep_chunk: int | None = None):
    """Bulge chasing on strip storage (f32 or complex64, 8 <= b <= 384).

    strips: (>= n_strips(n, b), b, 5b), contiguous; it is not written (the
    kernel chases a copy). Returns (d, e, vs, taus) in the layout of
    :func:`band_to_tridiag_strips_ref`: vs (nrec, ncmax, b) with unit heads,
    taus (nrec, ncmax), zeros in every slot no chase visits. With
    ``sweep_chunk`` only sweeps [sweep_lo, sweep_lo + sweep_chunk) are
    recorded; the chase always runs every sweep.
    """
    if not _build.on_cuda(strips):
        return band_to_tridiag_strips_ref(strips, n, b, sweep_lo, sweep_chunk)
    if not chaser_feasible(b, strips.dtype):
        raise ValueError(f"band_to_tridiag_strips kernel takes f32/complex64 and "
                         f"{MIN_BAND} <= b <= {MAX_BAND}, got {strips.dtype}, b={b}")
    if (strips.dim() != 3 or tuple(strips.shape[1:]) != (b, STRIP_W * b)
            or strips.shape[0] < n_strips(n, b)):
        raise ValueError(f"strips of shape {tuple(strips.shape)} do not hold n={n}, b={b}: "
                         f"need (>= {n_strips(n, b)}, {b}, {STRIP_W * b})")
    if not strips.is_contiguous():
        raise ValueError("band_to_tridiag_strips kernel needs contiguous strips")
    if n < 3:
        raise ValueError(f"band_to_tridiag_strips kernel needs n >= 3 (a sweep), got n={n}")
    nrec = n - 2 if sweep_chunk is None else sweep_chunk
    if nrec < 1:
        raise ValueError(f"sweep_chunk must be positive, got {sweep_chunk}")
    ncmax = -(-(n - 1) // b)
    work = strips.clone()
    # zero-fill is semantic: slots no chase visits must read as tau = 0,
    # and each lane's count of finished steps starts at 0
    vs = torch.zeros((nrec + 1, ncmax, b), dtype=strips.dtype, device=strips.device)
    taus = torch.zeros((nrec + 1, ncmax), dtype=strips.dtype, device=strips.device)
    done = torch.zeros(chase_lanes(n, b), dtype=torch.int32, device=strips.device)
    lib = _build.library("band2tridiag")
    with torch.cuda.device(strips.device):
        rc = lib.dlaf_band2tridiag(work.data_ptr(), vs.data_ptr(), taus.data_ptr(),
                                   done.data_ptr(), n, b, nrec, int(sweep_lo),
                                   int(strips.is_complex()), _build.stream_of(strips))
    _build.check(rc, lib, "band_to_tridiag_strips")
    band_to_tridiag_strips_kernel.launches += 1
    d, e = strips_extract_tridiag(work, n, b)
    return d, e, vs[:nrec], taus[:nrec]


band_to_tridiag_strips_kernel.launches = 0


class ChasePlan(NamedTuple):
    lanes: int          # concurrent chases of the widest wavefront step
    blocks: int         # the grid; lanes > blocks: a block takes several lanes a step
    instance: str       # "resident" or "streamed"
    smem_bytes: int     # the instance's dynamic shared memory a block


def chase_plan(n: int, b: int, dtype) -> ChasePlan:
    """The kernel's launch at (n, b) on the current CUDA device, without
    launching: its lanes, its grid, which never exceeds the blocks that are
    co-resident on the card, the instance and its shared memory."""
    if not chaser_feasible(b, dtype) or n < 3:
        raise ValueError(f"no K3 launch for n={n}, b={b}, {dtype}")
    out = (ctypes.c_int * 4)()
    lib = _build.library("band2tridiag")
    _build.check(lib.dlaf_band2tridiag_plan(n, b, int(dtype.is_complex), ctypes.addressof(out)),
                 lib, "band_to_tridiag_strips plan")
    return ChasePlan(out[0], out[1], "resident" if out[2] else "streamed", out[3])


# ---- the kernel's schedule, as a Python twin of csrc/band2tridiag.cu ------

LAG = 3   # wavefront steps between adjacent sweeps (csrc kLag)


def chase_lanes(n: int, b: int) -> int:
    """Lanes of the launch: lane w holds chases c = 3w .. 3w+2 of every sweep."""
    return (-(-(n - 1) // b) - 1) // LAG + 1


def wavefront_steps(n: int) -> int:
    """Steps of the launch; the last chase, (n - 3, 0), runs at the last."""
    return LAG * (n - 3) + 1


def lane_chase(n: int, b: int, w: int, t: int):
    """The chase (s, c) that lane ``w`` runs at step ``t``, or None."""
    s = t // LAG - w
    c = t - LAG * s
    if s < 0 or s >= n - 2 or c >= -(-(n - 1 - s) // b):
        return None
    return s, c


def happens_before(a: tuple[int, int], b: tuple[int, int]) -> bool:
    """Whether (lane, step) ``a`` finishes before ``b`` starts under the
    neighbour rule alone (lane w starts step t once lanes w - 1, w and
    w + 1 have finished step t - 1): the rule's edges join (w', t - 1) to
    (w, t) for |w - w'| <= 1, so a path from a to b exists iff
    |w_a - w_b| <= t_b - t_a and t_a < t_b."""
    return a[1] < b[1] and abs(a[0] - b[0]) <= b[1] - a[1]


def neighbour_schedule(n: int, b: int, blocks: int, rng) -> list:
    """One run of the launch's schedule, the blocks interleaved at random
    where the rule lets them: block k takes lanes k, k + blocks, ... in
    increasing order at each step, and lane w starts step t once lanes
    w - 1 and w + 1 have counted step t - 1 as done. Returns the chases
    (s, c) in the order they start, each with its (lane, step). Raises if
    no block can go on before all are done (a deadlock)."""
    lanes = chase_lanes(n, b)
    steps = wavefront_steps(n)
    own = [list(range(k, lanes, blocks)) for k in range(min(blocks, lanes))]
    done = [0] * lanes
    at = [(0, 0)] * len(own)          # each block's (step, index into its lanes)
    live = set(range(len(own)))
    order = []
    while live:
        ready = []
        for k in sorted(live):
            t, j = at[k]
            w = own[k][j]
            if all(done[u] >= t for u in (w - 1, w + 1) if 0 <= u < lanes):
                ready.append(k)
        if not ready:
            raise RuntimeError(f"neighbour schedule deadlocks at {at}")
        k = ready[int(rng.integers(len(ready)))]
        t, j = at[k]
        w = own[k][j]
        chase = lane_chase(n, b, w, t)
        if chase is not None:
            order.append((chase, (w, t)))
        done[w] = t + 1
        j += 1
        if j == len(own[k]):
            t, j = t + 1, 0
        at[k] = (t, j)
        if t == steps:
            live.discard(k)
    return order


def chase_cells(n: int, b: int, s: int, c: int) -> list:
    """The blocks of A that chase (s, c) reads and writes, as (row lo, row
    hi, col lo, col hi) of stored (lower, row >= col) entries: CY, S and
    B of its window."""
    i0 = s + 1 + c * b
    return [(i0, i0 + b, i0 - b, i0), (i0, i0 + b, i0, i0 + b), (i0 + b, i0 + 2 * b, i0, i0 + b)]
