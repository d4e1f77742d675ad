"""``potrf_info`` on inputs that are not positive definite: the port's info
against the JAX package's.

The same numpy matrix (f64, n = 64, nb = 32, SPD from a seed) with one
fault planted goes through ``dlaf_tpu.potrf_info`` and
``dlaf_tpu_torch.potrf_info`` for both uplos: a NaN pair off the diagonal
in the first leaf tile (JAX: 11, the first non-finite pivot), a NaN pair
in the second (41), a negative pivot inside the second leaf tile (33, the
tile's first column: a finite failing pivot turns the leaf's whole factor
NaN) and in the first (1). The info must be equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dlaf_tpu
import dlaf_tpu_torch

N, NB = 64, 32
FAULTS = {"nan-10-3": ((10, 3), np.nan, 11), "nan-40-38": ((40, 38), np.nan, 41),
          "neg-40": ((40, 40), -1e4, 33), "neg-5": ((5, 5), -1e4, 1)}


def _faulty(where, value):
    rng = np.random.default_rng(0)
    r = rng.uniform(-1, 1, (N, N))
    a = (r + r.T) / 2 + N * np.eye(N)
    i, j = where
    a[i, j] = a[j, i] = value
    return a


@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("fault", list(FAULTS))
def test_potrf_info_matches_jax(fault, uplo):
    where, value, want = FAULTS[fault]
    a = _faulty(where, value)
    _, info_jax = dlaf_tpu.potrf_info(jnp.asarray(a), uplo=uplo, nb=NB)
    _, info = dlaf_tpu_torch.potrf_info(torch.from_numpy(a), uplo=uplo, nb=NB)
    assert int(info) == int(info_jax) == want


def test_potrf_info_spd_is_zero():
    _, info = dlaf_tpu_torch.potrf_info(torch.from_numpy(_faulty((0, 0), N + 0.5)), nb=NB)
    assert int(info) == 0
