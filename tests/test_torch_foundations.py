"""The port's foundations against the JAX package: types, tune, the core
helpers, tri_inv and the generators (dlaf_tpu_torch vs dlaf_tpu, same numpy
inputs)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dlaf_tpu
import dlaf_tpu.types as jt
import dlaf_tpu_torch
import dlaf_tpu_torch.types as tt
from dlaf_tpu.ops import core as jcore
from dlaf_tpu.ops.householder import tri_inv as jax_tri_inv
from dlaf_tpu_torch import tune
from dlaf_tpu_torch.matrix import generators as gen
from dlaf_tpu_torch.ops import core as tcore
from dlaf_tpu_torch.ops.householder import tri_inv

from conftest import tol

DTYPES = ["float32", "float64", "complex64", "complex128"]


def _rand(rng, shape, dtype):
    d = np.dtype(dtype)
    x = rng.uniform(-1, 1, shape)
    if d.kind == "c":
        x = x + 1j * rng.uniform(-1, 1, shape)
    return x.astype(d)


# ---------------------------------------------------------------- types


@pytest.mark.parametrize("enum", ["Uplo", "Side", "Trans", "Diag"])
def test_enums_match(enum):
    assert {e.name: e.value for e in getattr(tt, enum)} == \
        {e.name: e.value for e in getattr(jt, enum)}


@pytest.mark.parametrize("name", DTYPES + ["bfloat16"])
def test_dtype_traits_match(name):
    jd = jnp.dtype(name)
    td = tt.as_dtype(name)
    assert tt.as_dtype(td) is td
    assert tt.is_complex_dtype(td) == jt.is_complex_dtype(jd)
    assert str(tt.real_dtype(td)) == f"torch.{jt.real_dtype(jd).name}"
    assert str(tt.complex_dtype(td)) == f"torch.{jt.complex_dtype(jd).name}"
    assert tt.eps(td) == jt.eps(jd)
    assert tt.total_ops(td, 3.0, 5.0) == jt.total_ops(jd, 3.0, 5.0)


def test_as_dtype_rejects_unknown():
    with pytest.raises(TypeError):
        tt.as_dtype("int32")


# ----------------------------------------------------------------- tune


@pytest.fixture()
def fresh_tune(monkeypatch):
    for f in dataclasses.fields(tune.TuneParameters):
        monkeypatch.delenv("DLAF_TPU_TORCH_" + f.name.upper(), raising=False)
    tune.reset_tune_parameters()
    yield monkeypatch
    tune.reset_tune_parameters()


def test_tune_fields_match_jax(fresh_tune):
    port = dataclasses.asdict(tune.TuneParameters())
    ref = dataclasses.asdict(dlaf_tpu.tune.TuneParameters())
    assert set(port) == set(ref)
    differ = {k for k in port if port[k] != ref[k]}
    assert differ == {"potrf_trailing_kernel"}
    assert port["potrf_trailing_kernel"] == "kernel"


def test_tune_precedence(fresh_tune):
    assert dlaf_tpu_torch.get_tune_parameters().leaf_block_size == 128
    fresh_tune.setenv("DLAF_TPU_TORCH_LEAF_BLOCK_SIZE", "64")
    fresh_tune.setenv("DLAF_TPU_TORCH_POTRF_TRAILING_KERNEL", "torch")
    fresh_tune.setenv("DLAF_TPU_TORCH_DEBUG_DUMP_CHOLESKY_DATA", "yes")
    tune.reset_tune_parameters()
    p = dlaf_tpu_torch.get_tune_parameters()
    assert (p.leaf_block_size, p.potrf_trailing_kernel, p.debug_dump_cholesky_data) == \
        (64, "torch", True)
    p = dlaf_tpu_torch.set_tune_parameters(leaf_block_size=32)
    assert (p.leaf_block_size, p.potrf_trailing_kernel) == (32, "torch")
    # explicit overrides accumulate
    p = dlaf_tpu_torch.set_tune_parameters(potrf_trailing_kernel="kernel")
    assert (p.leaf_block_size, p.potrf_trailing_kernel) == (32, "kernel")
    dlaf_tpu_torch.reset_tune_parameters()
    assert dlaf_tpu_torch.get_tune_parameters().leaf_block_size == 64


@pytest.mark.parametrize("name,value", [("potrf_trailing_kernel", "pallas"),
                                        ("potrf_trailing_kernel", "xla"),
                                        ("band_to_tridiag_kernel", "fast"),
                                        ("matmul_precision", "tf32")])
def test_tune_closed_sets(fresh_tune, name, value):
    with pytest.raises(ValueError, match=name):
        dlaf_tpu_torch.set_tune_parameters(**{name: value})
    fresh_tune.setenv("DLAF_TPU_TORCH_" + name.upper(), value)
    tune.reset_tune_parameters()
    with pytest.raises(ValueError, match=name):
        dlaf_tpu_torch.get_tune_parameters()


def test_tune_unknown_name(fresh_tune):
    with pytest.raises(ValueError, match="unknown"):
        dlaf_tpu_torch.set_tune_parameters(no_such_knob=1)
    with pytest.raises(ValueError, match="unknown"):
        dlaf_tpu_torch.from_dict({"no_such_knob": 1})


@pytest.mark.parametrize("jax_kernel,port_kernel", [("xla", "torch"), ("pallas", "kernel")])
def test_from_dict_round_trip(fresh_tune, jax_kernel, port_kernel):
    jp = dataclasses.replace(dlaf_tpu.tune.TuneParameters(), leaf_block_size=96,
                             potrf_trailing_kernel=jax_kernel,
                             band_to_tridiag_kernel="pallas")
    p = dlaf_tpu_torch.from_dict(dataclasses.asdict(jp))
    got, want = dataclasses.asdict(p), dataclasses.asdict(jp)
    assert got.pop("potrf_trailing_kernel") == port_kernel
    assert got.pop("band_to_tridiag_kernel") == "kernel"
    want.pop("potrf_trailing_kernel")
    want.pop("band_to_tridiag_kernel")
    assert got == want


# ----------------------------------------------------------------- core


def test_tf32_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("dtype", DTYPES)
def test_core_helpers_match_jax(dtype):
    rng = np.random.default_rng(11)
    a, b = _rand(rng, (9, 7), dtype), _rand(rng, (9, 7), dtype)
    sq, up = _rand(rng, (8, 8), dtype), _rand(rng, (8, 8), dtype)
    ta, tsq, tup = torch.from_numpy(a), torch.from_numpy(sq), torch.from_numpy(up)
    t = tol(np.dtype(dtype), 9)
    for trans in "NTC":
        np.testing.assert_array_equal(tcore.op_mat(ta, trans).resolve_conj().numpy(),
                                      np.asarray(jcore.op_mat(jnp.asarray(a), trans)))
    got = tcore.mm(ta, torch.from_numpy(b), ta="C").numpy()
    want = np.asarray(jcore.mm(jnp.asarray(a), jnp.asarray(b), ta="C"))
    assert np.abs(got - want).max() <= t * np.abs(want).max()
    np.testing.assert_array_equal(tcore.ct(ta).resolve_conj().numpy(),
                                  np.asarray(jcore.ct(jnp.asarray(a))))
    for k in (-1, 0, 2):
        np.testing.assert_array_equal(tcore.tril_mask(5, 7, k=k).numpy(),
                                      np.asarray(jcore.tril_mask(5, 7, k=k)))
    for lower in (True, False):
        for unit in (False, True):
            np.testing.assert_array_equal(tcore.take_tri(tsq, lower, unit).numpy(),
                                          np.asarray(jcore.take_tri(jnp.asarray(sq), lower, unit)))
        np.testing.assert_array_equal(tcore.symmetrize_tri(tsq, lower).resolve_conj().numpy(),
                                      np.asarray(jcore.symmetrize_tri(jnp.asarray(sq), lower)))
        np.testing.assert_array_equal(
            tcore.set_tri(tsq, tup, lower).numpy(),
            np.asarray(jcore.set_tri(jnp.asarray(sq), jnp.asarray(up), lower)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("n", [50, 200])
def test_tri_inv_matches_jax(dtype, lower, n):
    rng = np.random.default_rng(n)
    r = _rand(rng, (n, n), dtype) / n
    a = (np.tril(r, -1) if lower else np.triu(r, 1)) + np.diag(rng.uniform(1, 2, n)).astype(dtype)
    got = tri_inv(torch.from_numpy(a), lower=lower, nb=64).numpy()
    want = np.asarray(jax_tri_inv(jnp.asarray(a), lower=lower, nb=64))
    assert np.abs(got - want).max() <= tol(np.dtype(dtype), n) * np.abs(want).max()
    zero = np.triu(got, 1) if lower else np.tril(got, -1)
    assert np.abs(zero).max() == 0.0


# ----------------------------------------------------------- generators


@pytest.mark.parametrize("dtype", DTYPES)
def test_generators(dtype, monkeypatch):
    # a small symmetrization block so the block-pair loop crosses blocks
    monkeypatch.setattr(gen, "_SYM_BLOCK", 16)
    n = 40
    g = torch.Generator().manual_seed(0)
    r = gen.random_general(g, (n, n), dtype).numpy()
    assert r.dtype == np.dtype(dtype)
    assert np.abs(r.real).max() <= 1 and abs(r.real.mean()) < 0.15
    h = gen.random_hermitian(torch.Generator().manual_seed(1), n, dtype).numpy()
    np.testing.assert_array_equal(h, h.conj().T)
    a = gen.random_hermitian_positive_definite(torch.Generator().manual_seed(2), n, dtype).numpy()
    np.testing.assert_array_equal(a, a.conj().T)
    w = np.linalg.eigvalsh(a.astype(np.complex128))
    assert n / 2 <= w.min() and w.max() <= 3 * n / 2
    again = gen.random_hermitian_positive_definite(torch.Generator().manual_seed(2), n, dtype)
    np.testing.assert_array_equal(again.numpy(), a)
