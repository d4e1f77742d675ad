"""K1: Cholesky factor of one SPD tile — hand-written Hopper kernel.

Replaces the Pallas kernel ``dlaf_tpu/ops/pallas/potrf.py`` ``potrf_tile``
(``_potrf_u_kernel``, ``_potrf_u_kernel_blk``). The CUDA source is
``dlaf_tpu_torch/csrc/potrf_tile.cu``: one launch of a thread-block cluster
of 8 blocks that holds the f32 working tile in its distributed shared
memory up to nb = 536 (in device memory beyond, the same kernel); its
header says what bounds it on the card and how the design answers.

On the POTRF path the leaf's dtype decides the route (``ops/leaf.py``):
f32 leaves reach this kernel. Its bf16 instantiation is reached only by
calling :func:`potrf_tile` directly: ``potrf`` on a bf16 CUDA matrix stops
in ``tri_inv`` (``ops/householder.py``), because
``torch.linalg.solve_triangular`` has no bf16 kernel on the card.

:func:`potrf_tile` dispatches on the tensor's device: a CPU tensor takes the
plain PyTorch version :func:`potrf_tile_ref`; a CUDA tensor launches the
kernel or raises. There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..core import ct, symmetrize_tri, tril_mask
from . import _build

KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# the largest nb: a 32-row slab copy of the tile in one block's shared
# memory (232,448 bytes a block on an H100)
NB_MAX = 1808
_plans: dict = {}


def potrf_tile_plan(nb: int, bf16: bool = False) -> dict:
    """How K1 runs an nb tile on the current card: ``resident`` (the working
    tile in the cluster's shared memory, else in a device-memory buffer),
    ``smem_bytes`` a block, ``cluster_blocks``, and ``clusters``, how many
    such clusters the card can hold at once. Raises where the cluster
    cannot be placed. Queried once per (nb, dtype)."""
    key = (nb, bool(bf16))
    if key not in _plans:
        lib = _build.library("potrf_tile")
        out = (ctypes.c_int * 4)()
        _build.check(lib.dlaf_potrf_tile_plan(nb, int(bf16), out), lib, "potrf_tile plan")
        plan = dict(zip(("resident", "smem_bytes", "cluster_blocks", "clusters"), out))
        if plan["clusters"] < 1:
            raise RuntimeError(f"potrf_tile: a cluster of {plan['cluster_blocks']} blocks with "
                               f"{plan['smem_bytes']} bytes of shared memory each cannot be "
                               "placed on this card")
        _plans[key] = plan
    return _plans[key]


def potrf_tile_ref(a: torch.Tensor, upper: bool = False) -> torch.Tensor:
    """Plain version: ``torch.linalg.cholesky_ex`` on the mirrored tile.

    Reads only the ``upper`` (or lower) triangle of ``a`` and returns U
    (A = U^H U) or L (A = L L^H) with the other triangle zero. Where a
    pivot fails on a finite tile the factor's triangle is NaN, as XLA's
    Cholesky leaves it on the CPU. Where the tile holds a non-finite entry,
    XLA's factor lets the NaN flow forward instead: its columns are NaN
    from the first failing pivot on (``cholesky_ex``'s info), and here
    too, so that ``potrf_info`` reports that pivot as the JAX package does.
    bf16 is factored in f32 and rounded back.
    """
    work = a.float() if a.dtype == torch.bfloat16 else a
    sym = symmetrize_tri(work, lower=not upper)
    l, info = torch.linalg.cholesky_ex(sym)
    n = a.shape[0]
    cols = torch.arange(n, device=a.device) >= info - 1
    cols = cols | torch.isfinite(sym).all()
    bad = (info > 0) & tril_mask(n, device=a.device) & cols[None, :]
    l = l.masked_fill(bad, float("nan")).to(a.dtype)
    return ct(l).resolve_conj() if upper else l


def potrf_tile(a: torch.Tensor, upper: bool = False) -> torch.Tensor:
    """Cholesky factor of one SPD tile (f32/bf16 on the card), other
    triangle zeroed; the result is a new tensor.

    ``upper=False``: L (A = L L^T) from a's lower triangle; ``upper=True``:
    U (A = U^T U) from a's upper triangle. A non-positive pivot gives NaN
    that propagates to the rest of the factor (no trap, no early exit).
    The kernel takes nb % 8 == 0 up to ``NB_MAX`` = 1808 (its 32-row slab
    copy fills one block's shared memory on an H100); a larger nb raises.
    """
    if not _build.on_cuda(a):
        return potrf_tile_ref(a, upper)
    if a.dtype not in KERNEL_DTYPES:
        raise TypeError(f"potrf_tile kernel takes f32/bf16, got {a.dtype}")
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"potrf_tile needs a square tile, got {tuple(a.shape)}")
    nb = a.shape[0]
    if nb == 0 or nb % 8:
        raise ValueError(f"potrf_tile needs nb % 8 == 0, got nb={nb}")
    if nb > NB_MAX:
        raise ValueError(f"potrf_tile takes nb <= {NB_MAX}, got nb={nb}")
    if a.stride(1) != 1:
        raise ValueError("potrf_tile needs unit column stride")
    bf16 = a.dtype == torch.bfloat16
    lib = _build.library("potrf_tile")
    with torch.cuda.device(a.device):
        plan = potrf_tile_plan(nb, bf16)
        out = torch.empty((nb, nb), dtype=a.dtype, device=a.device)
        work = None if plan["resident"] else torch.empty((nb, nb), dtype=torch.float32,
                                                         device=a.device)
        rc = lib.dlaf_potrf_tile(a.data_ptr(), a.stride(0), out.data_ptr(), nb,
                                 None if work is None else work.data_ptr(), nb, int(upper),
                                 int(bf16), _build.stream_of(a))
    _build.check(rc, lib, "potrf_tile")
    potrf_tile.launches += 1
    return out


potrf_tile.launches = 0


def factor_deviation(got: torch.Tensor, want: torch.Tensor, c: float,
                     bf16: bool = False) -> float:
    """How far a factor lies from a reference factor, in units of the
    tolerance: the largest over the entries of

        |got - want| / (c eps32 (|want| + max off-diagonal |want|)
                        [+ half a bf16 ulp of max(|got|, |want|)])

    so that the factor is within tolerance where this is <= 1. The relative
    term holds each entry to its own size (the diagonal of a Cholesky
    factor is sqrt(n) times the off-diagonal); the absolute term covers the
    entries near 0. With ``bf16`` the factor ``got`` was rounded to bf16
    once from f32 work, and ``want`` is the f32 factor of the same input.
    NaN anywhere gives NaN. Works through 2048 rows at a time, so that an
    n = 32768 factor needs no full-size f64 temporary.
    """
    n, rows = want.shape[0], 2048
    off = 0.0
    for i in range(0, n, rows):
        w = want[i:i + rows].abs()
        w.diagonal(offset=i).zero_()
        off = max(off, float(w.max()))
    worst = 0.0
    for i in range(0, n, rows):
        g, w = got[i:i + rows].double(), want[i:i + rows].double()
        tol = w.abs().add_(off).mul_(c * torch.finfo(torch.float32).eps)
        if bf16:
            _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
            tol.add_(torch.ldexp(torch.ones_like(tol), e - 9))
        dev = float(g.sub_(w).abs_().div_(tol).max())
        if math.isnan(dev):
            return dev
        worst = max(worst, dev)
    return worst
