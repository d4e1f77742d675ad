"""K2: fused trailing update C <- C - op(X) Y — hand-written Hopper kernel.

Replaces the Pallas kernel ``dlaf_tpu/ops/pallas/trailing.py``
``ksub_matmul`` (``_ksub_kernel``). The CUDA source is
``dlaf_tpu_torch/csrc/ksub.cu``: the product and the subtract share one
register accumulator, so the product never reaches device memory, and C is
read once and written once, in place. Products are plain f32 FFMA (never
TF32), the accuracy of the JAX package's ``HIGHEST`` route.

:func:`ksub_matmul` dispatches on the tensor's device: a CPU tensor takes the
plain version :func:`ksub_matmul_ref`; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import torch

from . import _build


def _op(x: torch.Tensor, x_k_major: bool) -> torch.Tensor:
    return x.T if x_k_major else x


def ksub_matmul_ref(c, x, y, x_k_major: bool = True) -> torch.Tensor:
    """Plain version: ``c - op(x) @ y`` as a new tensor."""
    return c - _op(x, x_k_major) @ y


def ksub_available(c, x, y, x_k_major: bool = True) -> bool:
    """Whether :func:`ksub_matmul` takes these operands: f32 throughout.
    The kernel masks ragged edges itself, so no shape condition applies;
    the device decides the route inside :func:`ksub_matmul`."""
    return c.dtype == x.dtype == y.dtype == torch.float32


def ksub_matmul(c, x, y, x_k_major: bool = True) -> torch.Tensor:
    """C - op(X) Y written into ``c`` in place; returns ``c``.

    ``c`` (m, n) and ``y`` (k, n); ``x`` is (k, m) with ``x_k_major`` (op =
    transpose: the upper-POTRF panel layout) or (m, k) otherwise (plain NN).
    Operands may be row-strided views into a larger matrix: the kernel
    takes leading dimensions, so no copy is made, but each needs unit
    column stride. ``c`` must not overlap ``x`` or ``y``.
    """
    m, n = c.shape
    k = x.shape[0] if x_k_major else x.shape[1]
    if tuple(_op(x, x_k_major).shape) != (m, k) or tuple(y.shape) != (k, n):
        raise ValueError(f"ksub_matmul shapes: c {tuple(c.shape)}, x {tuple(x.shape)}"
                         f" (x_k_major={x_k_major}), y {tuple(y.shape)}")
    if not _build.on_cuda(c):
        return c.copy_(ksub_matmul_ref(c, x, y, x_k_major))
    if not ksub_available(c, x, y):
        raise TypeError(f"ksub_matmul kernel takes f32, got {c.dtype}, {x.dtype}, {y.dtype}")
    if not (x.device == y.device == c.device):
        raise ValueError("ksub_matmul operands on different devices")
    if any(t.stride(1) != 1 for t in (c, x, y)):
        raise ValueError("ksub_matmul needs unit column stride on c, x and y")
    if m == 0 or n == 0 or k == 0:
        return c
    lib = _build.library("ksub")
    with torch.cuda.device(c.device):
        rc = lib.dlaf_ksub(c.data_ptr(), c.stride(0), x.data_ptr(), x.stride(0),
                           y.data_ptr(), y.stride(0), m, n, k, int(x_k_major),
                           _build.stream_of(c))
    _build.check(rc, lib, "ksub_matmul")
    ksub_matmul.launches += 1
    return c


ksub_matmul.launches = 0
