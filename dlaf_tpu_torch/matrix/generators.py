"""Seeded matrix generators for tests, miniapps and benchmarks.

PyTorch counterpart of :mod:`dlaf_tpu.matrix.generators`. Each function is
driven by a ``torch.Generator`` and builds its matrix on that generator's
device. The distributions are those of the JAX generators; the bits are
not (``jax.random`` and PyTorch's generators differ), so tests that compare
the two packages make their inputs with numpy instead.
"""
from __future__ import annotations

import torch

from ..types import DTypeLike, as_dtype, real_dtype

# rows/cols of the blocks the in-place symmetrization works through: a
# 4096 x 4096 f32 temporary is 64 MiB, against 4 GiB for a full n = 32768
# temporary
_SYM_BLOCK = 4096


def random_general(generator: torch.Generator, shape, dtype: DTypeLike) -> torch.Tensor:
    """Uniform in [-1, 1] (complex: real and imaginary parts independently)."""
    dtype = as_dtype(dtype)
    rd = real_dtype(dtype)

    def uniform():
        u = torch.rand(shape, generator=generator, dtype=rd, device=generator.device)
        return u.mul_(2).sub_(1)

    if dtype.is_complex:
        return torch.complex(uniform(), uniform())
    return uniform()


def random_hermitian(generator: torch.Generator, n: int, dtype: DTypeLike) -> torch.Tensor:
    """Random hermitian with elements O(1) and real diagonal: (R + R^H)/2.

    Built in place, block pair by block pair, so the only full-size tensor
    is the result (a 4 GiB matrix at n = 32768 f32 needs no 4 GiB
    temporary)."""
    r = random_general(generator, (n, n), dtype)
    for i0 in range(0, n, _SYM_BLOCK):
        i1 = min(i0 + _SYM_BLOCK, n)
        for j0 in range(i0, n, _SYM_BLOCK):
            j1 = min(j0 + _SYM_BLOCK, n)
            upper, lower = r[i0:i1, j0:j1], r[j0:j1, i0:i1]
            t = (upper + lower.mH) / 2
            upper.copy_(t)
            lower.copy_(t.mH)
    return r


def random_hermitian_positive_definite(generator: torch.Generator, n: int,
                                       dtype: DTypeLike) -> torch.Tensor:
    """Hermitian positive definite with eigenvalues in ~[n/2, 3n/2]: the
    random hermitian matrix with n added to its diagonal, in place."""
    h = random_hermitian(generator, n, dtype)
    h.diagonal().add_(n)
    return h


def random_triangular(generator: torch.Generator, n: int, dtype: DTypeLike, lower: bool = True,
                      unit: bool = False) -> torch.Tensor:
    """Well-conditioned random triangular matrix: the strict triangle
    uniform in [-1, 1] over n (off-diagonal mass small, condition number
    O(1)), the diagonal uniform in [1, 2] (real), or ones with ``unit``.
    Built in place: the result is the only full-size tensor."""
    dtype = as_dtype(dtype)
    t = random_general(generator, (n, n), dtype)
    (t.tril_(-1) if lower else t.triu_(1)).div_(n)
    if unit:
        t.diagonal().fill_(1)
    else:
        d = torch.rand((n,), generator=generator, dtype=real_dtype(dtype),
                       device=generator.device)
        t.diagonal().copy_(d.add_(1))
    return t
