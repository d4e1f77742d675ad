"""The refusals of the K1, K2 and K6 wrappers on a CUDA tensor, on the CPU.

The device probe is faked so that every tensor looks like a CUDA tensor,
and the kernel library cannot load (or is a stand-in that records its
calls): each check must raise before a launch, and nothing may fall back
to the plain version. Also pins ``spawn_grid``'s default device.
"""
import ctypes
import inspect

import pytest
import torch

from dlaf_tpu_torch.comm.launch import spawn_grid
from dlaf_tpu_torch.ops.kernels import _build
from dlaf_tpu_torch.ops.kernels import potrf as kpotrf
from dlaf_tpu_torch.ops.kernels import trailing as ktrail


@pytest.fixture()
def fake_cuda(monkeypatch):
    """Every tensor looks like a CUDA tensor; the kernel library cannot load."""
    monkeypatch.setattr(_build, "on_cuda", lambda t: True)
    loaded = []

    def no_library(name):
        loaded.append(name)
        raise RuntimeError(f"cannot build {name}")

    monkeypatch.setattr(_build, "library", no_library)
    return loaded


# ------------------------------------------------------------------- K1


@pytest.mark.parametrize("nb", [1816, 2048])
def test_tile_above_nb_max_raises_before_loading(fake_cuda, nb):
    with pytest.raises(ValueError, match=f"nb <= {kpotrf.NB_MAX}"):
        kpotrf.potrf_tile(torch.zeros(nb, nb))
    assert fake_cuda == []


@pytest.mark.parametrize("dtype", [torch.float16, torch.complex64])
def test_tile_dtype_refused(fake_cuda, dtype):
    with pytest.raises(TypeError, match="f32/bf16"):
        kpotrf.potrf_tile(torch.eye(64, dtype=dtype))
    assert fake_cuda == []


def test_tile_empty_refused(fake_cuda):
    with pytest.raises(ValueError, match="nb % 8"):
        kpotrf.potrf_tile(torch.zeros(0, 0))


@pytest.mark.parametrize("nb", [8, 512, kpotrf.NB_MAX])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tile_in_range_loads_the_cluster_kernel(fake_cuda, nb, dtype):
    """Every nb % 8 == 0 up to NB_MAX goes to the kernel's library; there
    is no other route on the card."""
    with pytest.raises(RuntimeError, match="cannot build potrf_tile"):
        kpotrf.potrf_tile(torch.zeros(nb, nb, dtype=dtype), upper=True)
    assert fake_cuda == ["potrf_tile"]


class _PlanLib:
    """Stand-in for the potrf_tile library: its plan entry fills ``plan``."""

    def __init__(self, plan):
        self.plan, self.calls = plan, []

    def dlaf_potrf_tile_plan(self, nb, bf16, out):
        self.calls.append((nb, bf16))
        for i, v in enumerate(self.plan):
            out[i] = v
        return 0


@pytest.fixture()
def plan_lib(monkeypatch):
    def make(plan):
        lib = _PlanLib(plan)
        monkeypatch.setattr(_build, "library", lambda name: lib)
        monkeypatch.setattr(kpotrf, "_plans", {})
        return lib
    return make


def test_tile_plan_refuses_a_cluster_that_cannot_be_placed(plan_lib):
    plan_lib([1, 205440, 8, 0])
    with pytest.raises(RuntimeError, match="cluster of 8 blocks with 205440 bytes"):
        kpotrf.potrf_tile_plan(512)


def test_tile_plan_is_queried_once(plan_lib):
    lib = plan_lib([1, 205440, 8, 16])
    want = {"resident": 1, "smem_bytes": 205440, "cluster_blocks": 8, "clusters": 16}
    assert kpotrf.potrf_tile_plan(512) == want
    assert kpotrf.potrf_tile_plan(512) == want
    assert kpotrf.potrf_tile_plan(512, bf16=True) == want
    assert lib.calls == [(512, 0), (512, 1)]


# ------------------------------------------------------------------- K2


def test_ksub_bf16_refused(fake_cuda):
    z = torch.zeros(8, 8, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="f32"):
        ktrail.ksub_matmul(z, z, z)
    assert fake_cuda == []


@pytest.mark.parametrize("which", ["c", "y"])
def test_ksub_unit_column_stride(fake_cuda, which):
    ops = {n: torch.zeros(8, 8) for n in "cxy"}
    ops[which] = torch.zeros(8, 16)[:, ::2]
    with pytest.raises(ValueError, match="unit column stride"):
        ktrail.ksub_matmul(ops["c"], ops["x"], ops["y"])
    assert fake_cuda == []


@pytest.mark.parametrize("x_k_major", [True, False])
def test_ksub_overlap_refused(fake_cuda, x_k_major):
    buf = torch.zeros(64, 64)
    c, y = buf[:16, :16], torch.zeros(8, 16)
    x = buf[8:16, :16] if x_k_major else buf[8:24, :8]
    with pytest.raises(ValueError, match="c overlaps x"):
        ktrail.ksub_matmul(c, x, y, x_k_major=x_k_major)
    assert fake_cuda == []


def test_ksub_launches_the_tf32x3_library(fake_cuda):
    with pytest.raises(RuntimeError, match="cannot build ksub_tf32x3"):
        ktrail.ksub_matmul(torch.zeros(8, 8), torch.zeros(8, 8), torch.zeros(8, 8))
    assert fake_cuda == ["ksub_tf32x3"]


@pytest.mark.parametrize("x_k_major", [False, True])
def test_ksub_masked_launches_the_tf32x3_library(fake_cuda, x_k_major):
    """K6 is the masked instantiation of K2's kernel, in both layouts."""
    z = torch.zeros(8, 8)
    grow = torch.arange(8, dtype=torch.int32).reshape(8, 1)
    with pytest.raises(RuntimeError, match="cannot build ksub_tf32x3$"):
        ktrail.ksub_matmul_masked(z, torch.zeros(8, 8), torch.zeros(8, 8), grow,
                                  grow.reshape(1, 8), x_k_major=x_k_major)
    assert fake_cuda == ["ksub_tf32x3"]


def test_ksub_signatures_registered():
    assert "dlaf_ksub_tf32x3" in _build.SIGNATURES["ksub_tf32x3"]
    assert "dlaf_ksub_tf32x3_masked" in _build.SIGNATURES["ksub_tf32x3"]
    assert "ksub" not in _build.SIGNATURES           # the FFMA library is gone
    assert all(t in (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int)
               for sig in _build.SIGNATURES.values() for args in sig.values() for t in args)


class _MaskedLib:
    """Stand-in for the ksub_tf32x3 library: records K6's launches and
    reports the route as the launcher does (pipelined for X (m, k))."""

    def __init__(self):
        self.calls = []

    def dlaf_ksub_tf32x3_masked(self, c, ldc, x, ldx, y, ldy, grow, gcol, m, n, k, x_k_major,
                                stream, pipelined):
        self.calls.append({"ld": (ldc, ldx, ldy), "mnk": (m, n, k), "x_k_major": x_k_major,
                           "indices": (grow, gcol)})
        ctypes.c_int.from_address(pipelined).value = int(not x_k_major)
        return 0


@pytest.mark.parametrize("x_k_major", [False, True])
def test_ksub_masked_passes_views_and_indices_to_the_kernel(monkeypatch, x_k_major):
    """What K6's launch receives from strided views and strided index
    vectors: the views' leading dimensions, the shape and the layout; one
    launch counted, on the pipelined route where the launcher reports it,
    and ``c`` not touched on the host."""
    import contextlib
    lib = _MaskedLib()
    monkeypatch.setattr(_build, "on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "library", lambda name: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    c = torch.ones(12, 20)[:, 3:]                           # (12, 17), ldc 20
    x = torch.zeros(5, 16)[:, :12] if x_k_major else torch.zeros(12, 9)[:, :5]
    y = torch.zeros(5, 21)[:, 4:]
    grow = torch.arange(24, dtype=torch.int32).reshape(12, 2)[:, :1]
    gcol = torch.arange(34, dtype=torch.int32).reshape(1, 34)[:, ::2]
    before = ktrail.ksub_matmul_masked.launches
    piped = ktrail.ksub_matmul_masked.pipelined
    assert ktrail.ksub_matmul_masked(c, x, y, grow, gcol, x_k_major=x_k_major) is c
    assert ktrail.ksub_matmul_masked.launches == before + 1
    assert ktrail.ksub_matmul_masked.pipelined == piped + int(not x_k_major)
    (call,) = lib.calls
    assert call["ld"] == (20, x.stride(0), 21)
    assert call["mnk"] == (12, 17, 5) and call["x_k_major"] == int(x_k_major)
    assert bool((c == 1).all())


# -------------------------------------------------------------- spawn_grid


def test_spawn_grid_defaults_to_the_card():
    assert inspect.signature(spawn_grid).parameters["device"].default == "cuda"
