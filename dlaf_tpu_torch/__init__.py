"""dlaf_tpu_torch — the PyTorch/CUDA port of dlaf_tpu for one NVIDIA H100.

The JAX package :mod:`dlaf_tpu` is the reference; this package mirrors its
module paths. Ported so far: the local Cholesky factorization (``potrf``,
``potrf_info``) and the local two-stage Hermitian eigensolver (``eigh``,
``eigvalsh``) end to end, with hand-written Hopper kernels for their three
TPU kernels (``ops/kernels``, sources in ``csrc/``), the tuning
parameters, the matrix generators and the Cholesky and eigensolver
miniapps. The package never imports JAX.
"""
from . import types
from .algos.eigensolver.band2tridiag import band_to_tridiag_auto
from .algos.eigensolver.driver import _phase_normalize, eigh, get_band_size
from .algos.eigensolver.red2band import extract_band, reduction_to_band
from .algos.eigensolver.tridiag_dc import tridiag_eigh
from .api.local import potrf, potrf_info
from .ops.core import ct
from .tune import (TuneParameters, from_dict, get_tune_parameters,
                   reset_tune_parameters, set_tune_parameters)

__all__ = ["types", "potrf", "potrf_info", "eigh", "eigvalsh", "TuneParameters",
           "from_dict", "get_tune_parameters", "reset_tune_parameters",
           "set_tune_parameters"]


def eigvalsh(a, uplo: str = "L", **kw):
    """Eigenvalues only (skips both back-transformations). Sizes that are
    not a multiple of the band, or no bigger than it, go through
    :func:`eigh`, as in the JAX package."""
    n = a.shape[0]
    if uplo == "U":
        a = ct(a)
    tune = get_tune_parameters()
    b = kw.get("band") or get_band_size(tune.default_block_size)
    if n <= b or n % b:
        return eigh(a, **kw)[0]
    packed, _ = reduction_to_band(a, b)
    d, e, _, _ = band_to_tridiag_auto(extract_band(packed, b), b)
    er, _ = _phase_normalize(e, a.dtype)
    w, _ = tridiag_eigh(d, er, tune.laed4_max_iter)
    return w[:n]
