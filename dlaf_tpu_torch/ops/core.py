"""Core dense compute primitives shared by every algorithm.

PyTorch counterpart of :mod:`dlaf_tpu.ops.core`: dtype-generic matmul and
masking helpers on whole tensors. The MXU/SM-critical leaves live in
:mod:`dlaf_tpu_torch.ops.leaf` and :mod:`dlaf_tpu_torch.ops.kernels`.

Precision: f32 products keep f32 accuracy, never one TF32 pass. The JAX
package pins ``Precision.HIGHEST`` for f32 (``dlaf_tpu/ops/core.py``
``_PRECISIONS``); here both TF32 switches are turned off when this module
is imported, so every ``torch.matmul`` of the port (and cuDNN, which the
port does not call) runs in full f32. K2 (``kernels/trailing.py``) runs on
the tensor cores in a three-pass TF32 split, which holds f32's error
bound.
"""
from __future__ import annotations

import torch

from ..types import Trans

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# rows of the blocks hermitian_from_tri_ works through: its temporaries are
# at most 4096 x 4096 (64 MiB in f32), against 4 GiB for n = 32768
_SYM_BLOCK = 4096


def op_mat(a: torch.Tensor, trans) -> torch.Tensor:
    """Apply a BLAS transposition op to a 2-D tensor (a view, no copy)."""
    t = Trans(trans)
    if t == Trans.NoTrans:
        return a
    if t == Trans.Trans:
        return a.T
    return a.mH


def mm(a, b, ta=Trans.NoTrans, tb=Trans.NoTrans) -> torch.Tensor:
    """op(a) @ op(b) in the operands' own precision (f32 stays f32)."""
    return torch.matmul(op_mat(a, ta), op_mat(b, tb))


def ct(a: torch.Tensor) -> torch.Tensor:
    """Conjugate-transpose (hermitian adjoint) as a view — dtype generic."""
    return a.mH


def tril_mask(n: int, m: int | None = None, k: int = 0, dtype=torch.bool,
              device=None) -> torch.Tensor:
    """Mask of entries (r, c) with r >= c - k."""
    m = n if m is None else m
    r = torch.arange(n, device=device)[:, None]
    c = torch.arange(m, device=device)[None, :]
    return (r >= c - k).to(dtype)


def take_tri(a: torch.Tensor, lower: bool, unit: bool = False) -> torch.Tensor:
    """The referenced triangle of ``a`` (rest zeroed); with ``unit`` the
    stored diagonal is replaced by ones."""
    k = -1 if unit else 0
    t = torch.tril(a, k) if lower else torch.triu(a, -k)
    if unit:
        t = t + torch.eye(a.shape[0], a.shape[1], dtype=a.dtype, device=a.device)
    return t


def symmetrize_tri(a: torch.Tensor, lower: bool) -> torch.Tensor:
    """Full hermitian matrix from its stored triangle."""
    if lower:
        return torch.tril(a) + ct(torch.tril(a, -1))
    return torch.triu(a) + ct(torch.triu(a, 1))


def hermitian_from_tri_(a: torch.Tensor, lower: bool) -> torch.Tensor:
    """:func:`symmetrize_tri` in place on square ``a``: the other triangle
    is overwritten with the conjugate transpose of the stored one, by
    blocks of _SYM_BLOCK rows, so that no full-size temporary is made."""
    n = a.shape[0]
    for j0 in range(0, n, _SYM_BLOCK):
        j1 = min(j0 + _SYM_BLOCK, n)
        d = a[j0:j1, j0:j1]
        d.copy_(symmetrize_tri(d, lower))
        if lower:
            a[j0:j1, j1:] = a[j1:, j0:j1].mH
        else:
            a[j1:, j0:j1] = a[j0:j1, j1:].mH
    return a


def set_tri(c: torch.Tensor, update: torch.Tensor, lower: bool) -> torch.Tensor:
    """``update`` on the referenced triangle of ``c``, ``c`` elsewhere (BLAS
    herk/her2k semantics). Returns a new tensor, like the JAX helper."""
    rows, cols = c.shape
    mask = tril_mask(rows, cols, device=c.device) if lower else \
        ~tril_mask(rows, cols, k=-1, device=c.device)
    return torch.where(mask, update, c)
