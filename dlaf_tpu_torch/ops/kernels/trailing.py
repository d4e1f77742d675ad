"""K2 and K6: fused trailing updates C <- C - op(X) Y — hand-written Hopper kernels.

K2 replaces the Pallas kernel ``dlaf_tpu/ops/pallas/trailing.py``
``ksub_matmul`` (``_ksub_kernel``); K6 replaces ``ksub_matmul_masked``
(``_ksub_kernel_masked``), the same update restricted to the entries whose
global row index is at least their global column index (the distributed
POTRF's trailing updates). In both the product and the subtract share one
register accumulator, so the product never reaches device memory, and C is
read once and written once, in place.

Both are ``dlaf_tpu_torch/csrc/ksub_tf32x3.cu``: the products run on the
tensor cores in three TF32 passes (hi*hi + lo*hi + hi*lo of a two-term TF32
split of each f32 operand, the TPU kernel's bf16_3x scheme in TF32), which
holds f32's error bound; a single TF32 pass would not. K6 is that kernel's
masked instantiation: a 128 x 128 output tile wholly outside the mask
returns before it reads anything, and a live tile writes only the entries
inside the mask. K6's launches with X (m, k), 16-byte aligned operands and
no k split take the same file's pipelined kernel (TMA ring, warp-specialized
wgmma, persistent blocks over the live tiles), counted by
``ksub_matmul_masked.pipelined``; the others, and K2, keep the kernel above.

:func:`ksub_matmul` and :func:`ksub_matmul_masked` dispatch on the tensor's
device: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. :func:`ksub_matmul_split_ref` and
:func:`ksub_matmul_masked_split_ref` emulate the kernels' split in plain
PyTorch (:func:`tf32_split_matmul`), for the checks; no route runs them.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build


def _op(x: torch.Tensor, x_k_major: bool) -> torch.Tensor:
    return x.T if x_k_major else x


def ksub_matmul_ref(c, x, y, x_k_major: bool = True) -> torch.Tensor:
    """Plain version: ``c - op(x) @ y`` as a new tensor."""
    return c - _op(x, x_k_major) @ y


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 explicit mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds: on the int32 view,
    (bits + 0x1000) & ~0x1FFF."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split_matmul(a, b, terms: int = 3) -> torch.Tensor:
    """``a @ b`` as the 3xTF32 kernels compute it, in plain PyTorch: each
    f32 operand split as hi = tf32(v), lo = tf32(v - hi) and the product
    summed as hi*hi, + lo*hi (``terms`` >= 2), + hi*lo (``terms`` = 3).
    Products of TF32 values are exact in f32, so an f32 matmul (TF32 off)
    of the parts is the tensor cores' arithmetic but for the order and
    rounding of the sums. ``terms=1`` is one plain TF32 pass."""
    if terms not in (1, 2, 3):
        raise ValueError(f"terms must be 1, 2 or 3, got {terms}")
    ah, bh = tf32_round(a), tf32_round(b)
    prod = ah @ bh
    if terms >= 2:
        prod = prod + tf32_round(a - ah) @ bh
    if terms == 3:
        prod = prod + ah @ tf32_round(b - bh)
    return prod


def ksub_matmul_split_ref(c, x, y, x_k_major: bool = True, terms: int = 3) -> torch.Tensor:
    """K2's arithmetic in plain PyTorch, as a new tensor: ``c - op(x) @ y``
    with the product as :func:`tf32_split_matmul` computes it."""
    return c - tf32_split_matmul(_op(x, x_k_major), y, terms)


def ksub_matmul_masked_ref(c, x, y, grow, gcol, x_k_major: bool = True) -> torch.Tensor:
    """Plain version of K6: ``c - op(x) @ y`` where ``grow >= gcol``, else
    ``c``, as a new tensor."""
    return torch.where(grow >= gcol, c - _op(x, x_k_major) @ y, c)


def ksub_matmul_masked_split_ref(c, x, y, grow, gcol, x_k_major: bool = True,
                                 terms: int = 3) -> torch.Tensor:
    """K6's arithmetic in plain PyTorch: :func:`ksub_matmul_split_ref`
    where ``grow >= gcol``, else ``c``, as a new tensor."""
    return torch.where(grow >= gcol, ksub_matmul_split_ref(c, x, y, x_k_major, terms), c)


def ksub_available(c, x, y, x_k_major: bool = True) -> bool:
    """Whether :func:`ksub_matmul` (and :func:`ksub_matmul_masked`) take
    these operands: f32 throughout. Both kernels (K2 and its masked
    instantiation K6, ``csrc/ksub_tf32x3.cu``) mask ragged edges
    themselves, so no shape condition applies; the device decides the
    route inside the wrapper."""
    return c.dtype == x.dtype == y.dtype == torch.float32


def _span(t: torch.Tensor) -> tuple:
    """[first, last] byte addresses the tensor's elements can touch."""
    last = sum((s - 1) * st for s, st in zip(t.shape, t.stride()))
    return t.data_ptr(), t.data_ptr() + (last + 1) * t.element_size() - 1


def _check_no_overlap(what: str, c, *operands) -> None:
    """The kernels write ``c`` while they read the operands: refuse any
    operand whose storage range intersects ``c``'s."""
    if c.numel() == 0:
        return
    c0, c1 = _span(c)
    for name, t in zip("xy", operands):
        if t.numel() and t.device == c.device:
            t0, t1 = _span(t)
            if t0 <= c1 and c0 <= t1:
                raise ValueError(f"{what}: c overlaps {name} in memory")


def _shapes(what, c, x, y, x_k_major):
    m, n = c.shape
    k = x.shape[0] if x_k_major else x.shape[1]
    if tuple(_op(x, x_k_major).shape) != (m, k) or tuple(y.shape) != (k, n):
        raise ValueError(f"{what} shapes: c {tuple(c.shape)}, x {tuple(x.shape)}"
                         f" (x_k_major={x_k_major}), y {tuple(y.shape)}")
    return m, n, k


def _check_cuda(what, c, x, y):
    if not ksub_available(c, x, y):
        raise TypeError(f"{what} kernel takes f32, got {c.dtype}, {x.dtype}, {y.dtype}")
    if not (x.device == y.device == c.device):
        raise ValueError(f"{what} operands on different devices")
    if any(t.stride(1) != 1 for t in (c, x, y)):
        raise ValueError(f"{what} needs unit column stride on c, x and y")


def ksub_matmul(c, x, y, x_k_major: bool = True) -> torch.Tensor:
    """C - op(X) Y written into ``c`` in place; returns ``c``.

    ``c`` (m, n) and ``y`` (k, n); ``x`` is (k, m) with ``x_k_major`` (op =
    transpose: the upper-POTRF panel layout) or (m, k) otherwise (plain NN).
    Operands may be row-strided views into a larger matrix: the kernel
    takes leading dimensions, so no copy is made, but each needs unit
    column stride. ``c``'s storage range must not intersect ``x``'s or
    ``y``'s (it raises).
    """
    m, n, k = _shapes("ksub_matmul", c, x, y, x_k_major)
    if not _build.on_cuda(c):
        _check_no_overlap("ksub_matmul", c, x, y)
        return c.copy_(ksub_matmul_ref(c, x, y, x_k_major))
    _check_cuda("ksub_matmul", c, x, y)
    _check_no_overlap("ksub_matmul", c, x, y)
    if m == 0 or n == 0 or k == 0:
        return c
    lib = _build.library("ksub_tf32x3")
    with torch.cuda.device(c.device):
        rc = lib.dlaf_ksub_tf32x3(c.data_ptr(), c.stride(0), x.data_ptr(), x.stride(0),
                                  y.data_ptr(), y.stride(0), m, n, k, int(x_k_major),
                                  _build.stream_of(c))
    _build.check(rc, lib, "ksub_matmul")
    ksub_matmul.launches += 1
    return c


ksub_matmul.launches = 0


def ksub_matmul_plan(c, x, y, x_k_major: bool = True) -> dict:
    """How K2 runs these CUDA operands: ``vec16`` (16-byte copies, else
    4-byte copies for unaligned views) and ``split`` (blocks of a cluster
    sharing each output tile's k)."""
    m, n, k = _shapes("ksub_matmul", c, x, y, x_k_major)
    lib = _build.library("ksub_tf32x3")
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(c.device):
        rc = lib.dlaf_ksub_tf32x3_plan(x.data_ptr(), x.stride(0), y.data_ptr(), y.stride(0),
                                       m, n, k, out)
    _build.check(rc, lib, "ksub_matmul plan")
    return {"vec16": bool(out[0]), "split": out[1]}


def ksub_matmul_masked(c, x, y, grow, gcol, x_k_major: bool = True) -> torch.Tensor:
    """K6: C - op(X) Y written into ``c`` only where ``grow[i] >= gcol[j]``
    (elsewhere ``c`` is not written); returns ``c``.

    Operands as in :func:`ksub_matmul`, with unit column stride on every
    device. ``grow`` (m, 1) and ``gcol`` (1, n)
    are integer global indices (int32 for the kernel; any strides): the
    distributed POTRF passes global element indices, a sentinel above
    every row index for columns it must not update, and both vectors
    negated for the upper triangle's i <= j.
    """
    m, n, k = _shapes("ksub_matmul_masked", c, x, y, x_k_major)
    if tuple(grow.shape) != (m, 1) or tuple(gcol.shape) != (1, n):
        raise ValueError(f"ksub_matmul_masked index shapes: grow {tuple(grow.shape)}, "
                         f"gcol {tuple(gcol.shape)}, want ({m}, 1), (1, {n})")
    if any(t.stride(1) != 1 for t in (c, x, y)):
        # the kernel's layout, held on the CPU too, so that CPU runs hold
        # the callers to it
        raise ValueError("ksub_matmul_masked needs unit column stride on c, x and y")
    if not _build.on_cuda(c):
        _check_no_overlap("ksub_matmul_masked", c, x, y)
        return c.copy_(ksub_matmul_masked_ref(c, x, y, grow, gcol, x_k_major))
    _check_cuda("ksub_matmul_masked", c, x, y)
    _check_no_overlap("ksub_matmul_masked", c, x, y)
    if grow.dtype != torch.int32 or gcol.dtype != torch.int32:
        raise TypeError(f"ksub_matmul_masked kernel takes int32 indices, got "
                        f"{grow.dtype}, {gcol.dtype}")
    if not (grow.device == gcol.device == c.device):
        raise ValueError("ksub_matmul_masked indices on another device")
    if m == 0 or n == 0 or k == 0:
        return c
    gr, gc = grow.reshape(m).contiguous(), gcol.reshape(n).contiguous()
    lib = _build.library("ksub_tf32x3")
    route = ctypes.c_int(0)   # the launcher sets 1 where it took the pipelined route
    with torch.cuda.device(c.device):
        rc = lib.dlaf_ksub_tf32x3_masked(c.data_ptr(), c.stride(0), x.data_ptr(), x.stride(0),
                                         y.data_ptr(), y.stride(0), gr.data_ptr(), gc.data_ptr(),
                                         m, n, k, int(x_k_major), _build.stream_of(c),
                                         ctypes.addressof(route))
    _build.check(rc, lib, "ksub_matmul_masked")
    ksub_matmul_masked.launches += 1
    ksub_matmul_masked.pipelined += route.value
    return c


# K6's launches, and those of them that took the pipelined route (X (m, k),
# operands 16-byte aligned, no k split; the launcher reports it)
ksub_matmul_masked.launches = 0
ksub_matmul_masked.pipelined = 0
