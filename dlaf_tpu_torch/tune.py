"""Runtime-tunable parameters and the config override chain.

PyTorch counterpart of :mod:`dlaf_tpu.tune`: the same fields and defaults in
a dataclass, each overridable by an environment variable
``DLAF_TPU_TORCH_<NAME>`` and by explicit keywords to
:func:`set_tune_parameters` (precedence: defaults < env < explicit).

Kernel selectors name the port's routes: ``"torch"`` (plain PyTorch ops) and
``"kernel"`` (the hand-written Hopper kernel), where the JAX package says
``"xla"`` and ``"pallas"``. :func:`from_dict` translates a dict of the JAX
package's parameters into the port's.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

_ENV_PREFIX = "DLAF_TPU_TORCH_"


@dataclasses.dataclass
class TuneParameters:
    # default tile/block size of the LAPACK-flavored API
    default_block_size: int = 256
    # leaf size at which blocked recursions switch to a single-tile kernel
    leaf_block_size: int = 128
    # micro panel width inside the potrf leaf kernel (JAX/TPU kernel only;
    # the Hopper kernel derives its own, csrc/potrf_tile.cu)
    potrf_panel_size: int = 8
    # distributed POTRF wide-panel width and trailing chunks (not ported yet)
    potrf_dist_panel_width: int = 2048
    potrf_dist_trail_chunks: int = 24
    # eigensolver: smallest band of get_band_size, sweeps per compact-WY
    # group of the stage-4 back-transform, laed4 iteration cap
    eigensolver_min_band: int = 128
    bt_band_to_tridiag_hh_apply_group_size: int = 128
    # k-fused stage-4 streaming apply (JAX kernel K5, eigh_large; not
    # ported yet, kept so from_dict round-trips)
    bt_apply_fuse_groups: int = 8
    laed4_max_iter: int = 120
    # stage-2 route (algos/eigensolver/band2tridiag.py band_to_tridiag_auto):
    # "auto" (kernel K3 on a CUDA f32/complex64 tensor, the plain strip
    # chase on other CUDA tensors, the batched dense chase on the CPU),
    # "kernel" (K3 or raise), "strips", "pipelined", "sequential"
    band_to_tridiag_kernel: str = "auto"
    # trailing-update route of the (upper) POTRF hot loop: "torch"
    # (torch.matmul + subtract) or "kernel" (ops/kernels/trailing.py: the
    # product and the subtract in one register accumulator). "kernel" is
    # the default so that the main path on the card runs the hand kernel.
    potrf_trailing_kernel: str = "kernel"
    band_to_tridiag_dist_mode: str = "replicated"
    # f32 products always run in full f32 (ops/core.py turns TF32 off); the
    # field is kept for parity with the JAX package
    matmul_precision: str = "float32"
    debug_dump_cholesky_data: bool = False
    debug_dump_eigensolver_data: bool = False
    debug_dump_path: str = "dlaf_tpu_dump"


def _coerce(val: str, typ):
    if typ is bool:
        return val.strip().lower() in ("1", "true", "yes", "on")
    return typ(val)


_FIELD_TYPES = {f.name: type(f.default) for f in dataclasses.fields(TuneParameters)}


def _from_env(base: TuneParameters) -> TuneParameters:
    kw = {}
    for name, typ in _FIELD_TYPES.items():
        env = os.environ.get(_ENV_PREFIX + name.upper())
        if env is not None:
            kw[name] = _coerce(env, typ)
    return dataclasses.replace(base, **kw)


_params: Optional[TuneParameters] = None


def get_tune_parameters() -> TuneParameters:
    """Singleton accessor (reference ``getTuneParameters()``)."""
    global _params
    if _params is None:
        _params = _validate(_from_env(TuneParameters()))
    return _params


# string-valued knobs with a closed set of values: a typo must error, not
# silently select the default dispatch branch
_CHOICES = {
    "band_to_tridiag_kernel": {"auto", "strips", "pipelined", "sequential",
                               "kernel"},
    "band_to_tridiag_dist_mode": {"replicated", "pipelined"},
    "potrf_trailing_kernel": {"torch", "kernel"},
    "matmul_precision": {"default", "float32", "highest", "high"},
}

# JAX package value -> port value, per kernel selector
_FROM_JAX = {
    "potrf_trailing_kernel": {"xla": "torch", "pallas": "kernel"},
    "band_to_tridiag_kernel": {"pallas": "kernel"},
}


def _validate(params: TuneParameters) -> TuneParameters:
    for name, allowed in _CHOICES.items():
        v = getattr(params, name)
        if v not in allowed:
            raise ValueError(f"tune parameter {name}={v!r}: "
                             f"expected one of {sorted(allowed)}")
    return params


def _check_names(names) -> None:
    unknown = set(names) - set(_FIELD_TYPES)
    if unknown:
        raise ValueError(f"unknown tune parameters: {sorted(unknown)}")


def set_tune_parameters(**overrides) -> TuneParameters:
    """Apply explicit overrides incrementally on top of the current
    parameters (defaults < env < accumulated explicit overrides); use
    :func:`reset_tune_parameters` to drop all explicit overrides."""
    global _params
    base = get_tune_parameters()
    _check_names(overrides)
    _params = _validate(dataclasses.replace(base, **overrides))
    return _params


def reset_tune_parameters() -> None:
    global _params
    _params = None


def from_dict(d: dict) -> TuneParameters:
    """The port's parameters from a dict of the JAX package's, e.g.
    ``dataclasses.asdict(dlaf_tpu.get_tune_parameters())``. Kernel
    selectors are translated ("xla" -> "torch", "pallas" -> "kernel");
    every other field is carried over as it is. A linear-algebra library
    has no weights: these parameters and the input matrix are all that
    crosses from one package to the other."""
    _check_names(d)
    kw = {k: _FROM_JAX.get(k, {}).get(v, v) for k, v in d.items()}
    return _validate(TuneParameters(**kw))
