"""K3: stage-2 wavefront bulge chasing on strip storage — hand-written
Hopper kernel.

Replaces the Pallas kernel ``dlaf_tpu/ops/pallas/band2tridiag.py``
``band_to_tridiag_strips_pallas`` (``_make_kernel``). The CUDA source is
``dlaf_tpu_torch/csrc/band2tridiag.cu``: one persistent cooperative launch
walks the ~3n wavefront steps with a grid barrier between steps, a block
per concurrent chase; its header says what bounds it and how the design
answers.

:func:`band_to_tridiag_strips_kernel` dispatches on the tensor's device: a
CPU tensor takes the plain version :func:`band_to_tridiag_strips_ref` (the
sequential chase of :mod:`dlaf_tpu_torch.algos.eigensolver.band_strips`);
a CUDA tensor launches the kernel or raises. There is no fallback from one
to the other.
"""
from __future__ import annotations

import ctypes

import torch

from ...algos.eigensolver.band_strips import (STRIP_W, band_to_tridiag_strips,
                                             n_strips, strips_extract_tridiag)
from . import _build

KERNEL_DTYPES = (torch.float32, torch.complex64)
MIN_BAND = 8
# csrc/band2tridiag.cu kMaxB: the row pointers, five length-b vectors and
# four partial-sum tables in shared memory stay under 227 KB in complex64
MAX_BAND = 384

band_to_tridiag_strips_ref = band_to_tridiag_strips


def chaser_feasible(b: int, dtype) -> bool:
    """Whether the kernel takes band ``b`` in ``dtype``: f32 or complex64,
    and 8 <= b <= 384 (the kernel's shared-memory plan). The launch sizes
    its grid to the blocks that fit on the card, so there is no co-residency
    condition on n."""
    return dtype in KERNEL_DTYPES and MIN_BAND <= b <= MAX_BAND


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
    # zero-fill is semantic: slots no chase visits must read as tau = 0
    vs = torch.zeros((nrec + 1, ncmax, b), dtype=strips.dtype, device=strips.device)
    taus = torch.zeros((nrec + 1, ncmax), dtype=strips.dtype, device=strips.device)
    lib = _build.library("band2tridiag")
    with torch.cuda.device(strips.device):
        rc = lib.dlaf_band2tridiag(work.data_ptr(), vs.data_ptr(), taus.data_ptr(), n, b,
                                   nrec, int(sweep_lo), int(strips.is_complex()),
                                   _build.stream_of(strips))
    _build.check(rc, lib, "band_to_tridiag_strips")
    band_to_tridiag_strips_kernel.launches += 1
    d, e = strips_extract_tridiag(work, n, b)
    return d, e, vs[:nrec], taus[:nrec]


band_to_tridiag_strips_kernel.launches = 0


def chase_plan(n: int, b: int, dtype) -> tuple[int, int]:
    """(lanes, blocks) of the kernel's launch at (n, b) on the current CUDA
    device, without launching: the concurrent chases of the widest
    wavefront step, and the grid, which never exceeds the blocks that are
    co-resident on the card. Where lanes > blocks a block takes several
    lanes per step."""
    if not chaser_feasible(b, dtype) or n < 3:
        raise ValueError(f"no K3 launch for n={n}, b={b}, {dtype}")
    out = (ctypes.c_int * 2)()
    lib = _build.library("band2tridiag")
    _build.check(lib.dlaf_band2tridiag_plan(n, b, int(dtype.is_complex), ctypes.addressof(out)),
                 lib, "band_to_tridiag_strips plan")
    return out[0], out[1]
