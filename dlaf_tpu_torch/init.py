"""Runtime initialization.

Counterpart of :mod:`dlaf_tpu.init` (reference
``dlaf::initialize/finalize/ScopedInitializer``, ``src/init.cpp:306-379``):
one place that brings the runtime up. Where the JAX package sets XLA's
persistent compile cache, the port names the directory its Hopper kernels
are built into (``ops/kernels/_build.py``); ``distributed=True`` joins a
``torch.distributed`` process group (JAX: ``jax.distributed.initialize``);
``print_config`` dumps the configuration (reference
``--dlaf:print-config``).
"""
from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

from .ops.kernels import _build
from .tune import get_tune_parameters

_initialized = False
_joined = False


def default_backend(device_type: str, world_size: int) -> str:
    """The process group's backend: nccl where every rank has a card of
    its own, gloo on the CPU or for several ranks on one card (NCCL
    refuses that). The ranks on this host are ``LOCAL_WORLD_SIZE`` where
    the launcher sets it (torchrun does), else the whole world."""
    if device_type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


def initialize(cache_dir: Optional[str] = None, print_config: bool = False,
               distributed: bool = False, device: str = "cuda",
               backend: Optional[str] = None, **distributed_kw) -> None:
    """Idempotent runtime bring-up.

    ``cache_dir``: the directory the Hopper kernels are built into and
    loaded from (default ``build/dlaf_tpu_torch`` at the repository root).
    ``distributed``: join a process group unless one is up; by default from
    torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``; ``distributed_kw`` go to ``init_process_group``), with
    :func:`default_backend` of ``device`` ("cuda" or "cpu") unless
    ``backend`` is given. A rank on "cuda" is bound to
    ``cuda:{rank % device_count}``; where no CUDA device is present that
    raises."""
    global _initialized, _joined
    if _initialized:
        return
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("initialize(device='cuda'): no CUDA device is available")
    if cache_dir is not None:
        _build.BUILD_DIR = Path(cache_dir)
    if distributed and not dist.is_initialized():
        world = int(distributed_kw.get("world_size", os.environ.get("WORLD_SIZE", "1")))
        kw = dict(distributed_kw)
        if "store" not in kw:
            kw.setdefault("init_method", "env://")
        dist.init_process_group(backend or default_backend(device, world), **kw)
        _joined = True
    if device == "cuda":
        rank = dist.get_rank() if dist.is_initialized() else 0
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if print_config:
        tp = get_tune_parameters()
        print("dlaf_tpu_torch configuration:")
        if device == "cuda":
            print(f"  device: {torch.cuda.get_device_name()}  count: {torch.cuda.device_count()}")
        else:
            print("  device: cpu  count: 1")
        if dist.is_initialized():
            print(f"  process group: {dist.get_backend()}  rank {dist.get_rank()} "
                  f"of {dist.get_world_size()}")
        print(f"  kernel build directory: {_build.BUILD_DIR}")
        for f in dataclasses.fields(tp):
            print(f"  {f.name}: {getattr(tp, f.name)}")
    _initialized = True


def finalize() -> None:
    """Leave the process group that :func:`initialize` joined (one that
    was up before it is left alone)."""
    global _initialized, _joined
    if _joined and dist.is_initialized():
        dist.destroy_process_group()
    _joined = False
    _initialized = False


class ScopedInitializer:
    """``with ScopedInitializer(): ...`` (reference ``dlaf::ScopedInitializer``)."""

    def __init__(self, **kw):
        self._kw = kw

    def __enter__(self):
        initialize(**self._kw)
        return self

    def __exit__(self, *exc):
        finalize()
        return False
