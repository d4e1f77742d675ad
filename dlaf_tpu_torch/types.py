"""Core scalar/enum types for dlaf_tpu_torch.

PyTorch counterpart of :mod:`dlaf_tpu.types`: the BLAS-style enums shared by
every algorithm, dtype traits over ``torch.dtype`` and the flop-accounting
helper used by the miniapps (reference ``include/dlaf/types.h``
``total_ops``). Every function takes a ``torch.dtype``, a numpy dtype or a
dtype name, so callers holding numpy arrays and callers holding tensors use
the same helpers.
"""
from __future__ import annotations

import enum
from typing import Union

import numpy as np
import torch


class Uplo(str, enum.Enum):
    """Which triangle of a matrix is referenced (BLAS 'L'/'U')."""

    Lower = "L"
    Upper = "U"


class Side(str, enum.Enum):
    """Side of a triangular/hermitian factor in a product (BLAS 'L'/'R')."""

    Left = "L"
    Right = "R"


class Trans(str, enum.Enum):
    """Transposition op (BLAS 'N'/'T'/'C')."""

    NoTrans = "N"
    Trans = "T"
    ConjTrans = "C"


class Diag(str, enum.Enum):
    """Unit or non-unit diagonal for triangular matrices (BLAS 'U'/'N')."""

    Unit = "U"
    NonUnit = "N"


DTypeLike = Union[str, np.dtype, type, torch.dtype]

_BY_NAME = {
    "float32": torch.float32, "float64": torch.float64,
    "bfloat16": torch.bfloat16, "float16": torch.float16,
    "complex64": torch.complex64, "complex128": torch.complex128,
}
_REAL_OF = {torch.complex64: torch.float32, torch.complex128: torch.float64}
_COMPLEX_OF = {torch.float64: torch.complex128}


def as_dtype(dtype: DTypeLike) -> torch.dtype:
    """``torch.dtype`` of a torch dtype, numpy dtype or dtype name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    try:
        return _BY_NAME[name]
    except KeyError:
        raise TypeError(f"unsupported dtype {dtype!r}") from None


def is_complex_dtype(dtype: DTypeLike) -> bool:
    return as_dtype(dtype).is_complex


def real_dtype(dtype: DTypeLike) -> torch.dtype:
    """Base real type of a (possibly complex) dtype (reference ``BaseType``)."""
    d = as_dtype(dtype)
    return _REAL_OF.get(d, d)


def complex_dtype(dtype: DTypeLike) -> torch.dtype:
    """Complex type with matching precision (reference ``ComplexType``)."""
    d = as_dtype(dtype)
    if d.is_complex:
        return d
    return _COMPLEX_OF.get(d, torch.complex64)


def eps(dtype: DTypeLike) -> float:
    """Machine epsilon of the base real type (used for residual bounds)."""
    return float(torch.finfo(real_dtype(dtype)).eps)


def total_ops(dtype: DTypeLike, add: float, mul: float) -> float:
    """Total scalar flops for ``add`` additions and ``mul`` multiplications:
    real dtypes count add+mul, complex dtypes 2*add + 6*mul (reference
    ``include/dlaf/types.h`` ``total_ops``)."""
    if is_complex_dtype(dtype):
        return 2.0 * add + 6.0 * mul
    return float(add) + float(mul)
