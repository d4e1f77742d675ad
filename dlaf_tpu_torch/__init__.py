"""dlaf_tpu_torch — the PyTorch/CUDA port of dlaf_tpu for one NVIDIA H100.

The JAX package :mod:`dlaf_tpu` is the reference; this package mirrors its
module paths. Ported so far: the local Cholesky factorization (``potrf``,
``potrf_info``) end to end, with hand-written Hopper kernels for its two
TPU kernels (``ops/kernels``, sources in ``csrc/``), the tuning
parameters, the matrix generators and the Cholesky miniapp. The package
never imports JAX.
"""
from . import types
from .api.local import potrf, potrf_info
from .tune import (TuneParameters, from_dict, get_tune_parameters,
                   reset_tune_parameters, set_tune_parameters)

__all__ = ["types", "potrf", "potrf_info", "TuneParameters", "from_dict",
           "get_tune_parameters", "reset_tune_parameters", "set_tune_parameters"]
