"""dlaf_tpu_torch — the PyTorch/CUDA port of dlaf_tpu for one NVIDIA H100.

The JAX package :mod:`dlaf_tpu` is the reference; this package mirrors its
module paths and keeps its surface (``dlaf_tpu/__init__.py``). Ported: the
whole local API (the Cholesky factorization ``potrf``/``potrf_info``, the
BLAS-3 ``trsm``, ``trmm``, ``hemm``, ``herk``, ``gemm``, the two-stage
Hermitian eigensolver ``eigh``/``eigvalsh``, its memory-planned form
``eigh_large``/``eigvalsh_large``, and the generalized eigensolver
``hegst``/``eigh_gen``), with hand-written Hopper kernels for the TPU
kernels on their paths (``ops/kernels``, sources in ``csrc/``); the local
auxiliaries (``algos/norm.py``, ``algos/permutations.py``), the tuning
parameters, the matrix generators, all twelve miniapps and
``kernel_runner``. The distributed data model (``dist``, ``comm`` on
``torch.distributed``, ``DistMatrix``, ``Grid`` with ``Grid.multihost``),
the distributed Cholesky (``cholesky``, ``cholesky_info``, with kernel
K6), the distributed eigensolver (``eigh_dist``, ``eigvalsh_dist``,
``eigh_gen_dist``, kernel K3 on every rank's replicated stage 2) and the
distributed BLAS-3 (``triangular_solver``, ``general_multiplication``,
``hermitian_multiplication``, ``triangular_multiplication``,
``generalized_to_standard_dist``, ``max_norm``, ``permute``) run one
process per rank of a process ``Grid``. The user surfaces: the
ScaLAPACK-style API (``api/scalapack.py``), the C API (``native/``: its
header ``dlaf_tpu_c.h`` and the shim that :func:`native.build_c_api`
builds), ``init`` (``initialize``/``finalize``/``ScopedInitializer``),
matrix files and printing (``matrix/io.py``, ``matrix/printing.py``).
The collective-schedule checker (``debug.py``: ``check_collective_safety``,
``collective_schedule``, ``assert_same_schedule``, ``record_schedule``)
runs a distributed call on every rank and compares the collectives the
ranks issue, on CPU ranks (``spawn_grid(fn, grid, device="cpu")``) or on
the card; with it every module of ``dlaf_tpu`` is ported.
The package never imports JAX.
"""
from . import dist, ops, types
from .algos.cholesky import cholesky, cholesky_info
from .algos.eigensolver.band2tridiag import band_to_tridiag_auto
from .algos.eigensolver.dist_driver import eigh_dist, eigh_gen_dist, eigvalsh_dist
from .algos.eigensolver.driver import _phase_normalize, eigh, eigh_gen, get_band_size
from .algos.eigensolver.large import eigh_large, eigvalsh_large
from .algos.eigensolver.red2band import extract_band, reduction_to_band
from .algos.eigensolver.tridiag_dc import tridiag_eigh
from .algos.gen_to_std import generalized_to_standard as hegst
from .algos.gen_to_std import generalized_to_standard_dist
from .algos.general import (general_multiplication, hermitian_multiplication,
                            triangular_multiplication)
from .algos.norm import max_norm
from .algos.permutations import permute
from .algos.triangular import triangular_solver
from .api.local import gemm, hemm, herk, potrf, potrf_info, trmm, trsm
from .comm.mesh import Grid
from .matrix.dist_matrix import DistMatrix
from .ops.core import ct
from .tune import (TuneParameters, from_dict, get_tune_parameters,
                   reset_tune_parameters, set_tune_parameters)

__version__ = "0.1.0"

__all__ = ["dist", "ops", "types", "potrf", "potrf_info", "trsm", "trmm", "hemm", "herk", "gemm",
           "eigh", "eigvalsh", "eigh_gen", "hegst", "eigh_large", "eigvalsh_large",
           "cholesky", "cholesky_info", "eigh_dist", "eigvalsh_dist", "eigh_gen_dist",
           "triangular_solver", "general_multiplication",
           "hermitian_multiplication", "triangular_multiplication",
           "generalized_to_standard_dist", "max_norm", "permute", "DistMatrix", "Grid",
           "TuneParameters",
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
