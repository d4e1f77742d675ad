"""The port's DistMatrix, Grid, collectives and panel gathers against the
JAX package's.

Grids (1, 1) (in this process: it needs no process group), (2, 2) and
(2, 3) (gloo ranks spawned by ``spawn_grid``, one spawn per grid and
order, in a background thread while the JAX side runs), each with rank
order R and C: every rank's shard against the JAX shard of the device at
the same grid position (``pad_identity`` included), the from_global /
to_global round trip, ``diagonal()`` against ``DistMatrix.diagonal`` of
JAX, rank -> (p, q) against JAX's device placement, and the tile-major
panel gathers of ``comm/panel.py`` against the padded global matrix.
"""
import concurrent.futures
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlaf_tpu.comm.mesh import Grid as JaxGrid
from dlaf_tpu.dist import Distribution as JaxDistribution
from dlaf_tpu.matrix.dist_matrix import DistMatrix as JaxDistMatrix
from dlaf_tpu_torch.comm import collectives as coll
from dlaf_tpu_torch.comm import panel
from dlaf_tpu_torch.comm.launch import spawn_grid
from dlaf_tpu_torch.comm.mesh import COL_AXIS, ROW_AXIS, Grid

import torch_dist_ranks as ranks

GRIDS = [((1, 1), "R"), ((2, 2), "R"), ((2, 2), "C"), ((2, 3), "R"), ((2, 3), "C")]
GRID_IDS = [f"{g[0]}x{g[1]}{o}" for g, o in GRIDS]


def _inputs():
    rng = np.random.default_rng(5)
    herm = rng.standard_normal((72, 72)) + 1j * rng.standard_normal((72, 72))
    return {
        # key: (global matrix, nb, pad_identity)
        "square": (rng.standard_normal((100, 100)), 16, False),
        "tall_pad": (rng.standard_normal((80, 48)).astype(np.float32), 16, True),
        "herm_c128": ((herm + herm.conj().T) / 2, 16, True),
        "spd_pad": (ranks.spd(100, 1), 32, True),
    }


CASE_KEYS = list(_inputs())


def _run_port():
    cases = [(k, a, nb, pad) for k, (a, nb, pad) in _inputs().items()]
    out = {}
    for gs, order in GRIDS:
        if gs == (1, 1):
            out[(gs, order)] = [ranks.dist_matrix_cases(cases, Grid(gs, order=order),
                                                        torch.device("cpu"))]
            continue
        out[(gs, order)] = spawn_grid(functools.partial(ranks.dist_matrix_cases, cases),
                                      gs, backend="gloo", device="cpu", order=order,
                                      timeout=600)
    return out


@pytest.fixture(scope="module")
def results():
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(_run_port)
        jax_side = {}
        for gs, order in GRIDS:
            g = JaxGrid(gs, order=order)
            for key, (a, nb, pad) in _inputs().items():
                dm = JaxDistMatrix.from_global(jnp.asarray(a), nb, g, pad_identity=pad)
                jax_side[(gs, order, key)] = (np.asarray(dm.data), np.asarray(dm.diagonal()))
        return port.result(), jax_side


def _padded(a, nb, gs, pad):
    d = JaxDistribution(a.shape, (nb, nb), gs)
    pm, pn = d.padded_size
    ap = np.zeros((pm, pn), a.dtype)
    ap[:a.shape[0], :a.shape[1]] = a
    if pad:
        k = min(a.shape)
        idx = np.arange(k, min(pm, pn))
        ap[idx, idx] = 1
    return ap


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_rank_coords_match_jax_devices(results, grid):
    """Rank k sits where the JAX grid of the same order puts device k."""
    port, _ = results
    gs, order = grid
    devs = np.vectorize(lambda d: d.id)(JaxGrid(gs, order=order).mesh.devices)
    for r in port[grid]:
        p, q = r["coords"]
        assert devs[p, q] == jax.devices()[r["rank"]].id


@pytest.mark.parametrize("key", CASE_KEYS)
@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_shards_match_jax(results, grid, key):
    port, jax_side = results
    data, _ = jax_side[(grid[0], grid[1], key)]
    for r in port[grid]:
        p, q = r["coords"]
        np.testing.assert_array_equal(r[key]["shard"], data[p, q])
        assert tuple(r[key]["local_shape"]) == data.shape[-2:]


@pytest.mark.parametrize("key", CASE_KEYS)
@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_round_trip(results, grid, key):
    port, _ = results
    a = _inputs()[key][0]
    for r in port[grid]:
        np.testing.assert_array_equal(r[key]["global"], a)


@pytest.mark.parametrize("key", CASE_KEYS)
@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_diagonal_matches_jax(results, grid, key):
    port, jax_side = results
    _, diag = jax_side[(grid[0], grid[1], key)]
    for r in port[grid]:
        np.testing.assert_array_equal(r[key]["diag"], diag)


@pytest.mark.parametrize("key", CASE_KEYS)
@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_panel_gathers(results, grid, key):
    """all_tiles over each axis is tile-major by global tile,
    gather_col_panel is the padded global column panel, and bcast_row_slab
    hands every rank of a grid column the owner's local rows."""
    port, jax_side = results
    gs = grid[0]
    a, nb, pad = _inputs()[key]
    ap = _padded(a, nb, gs, pad)
    data, _ = jax_side[(grid[0], grid[1], key)]
    for r in port[grid]:
        p, q = r["coords"]
        np.testing.assert_array_equal(r[key]["row_slab"], data[gs[0] - 1, q][:nb])
        tr, tc = r[key]["tiles_r"], r[key]["tiles_c"]
        for g in range(tr.shape[0]):
            np.testing.assert_array_equal(tr[g], ap[g * nb:(g + 1) * nb, q * nb:(q + 1) * nb])
        for g in range(tc.shape[0]):
            np.testing.assert_array_equal(tc[g], ap[p * nb:(p + 1) * nb, g * nb:(g + 1) * nb])
        np.testing.assert_array_equal(r[key]["col_panel"], ap[:, nb + 3:nb + 8])


def test_grid_needs_a_process_group():
    with pytest.raises(ValueError, match="process group of 4 ranks"):
        Grid((2, 2))
    with pytest.raises(ValueError, match="order"):
        Grid((1, 1), order="X")
    g = Grid((1, 1))
    assert g.coords == (0, 0) and g.size == 1


def test_size_one_collectives_are_identities():
    g = Grid((1, 1))
    x = torch.arange(12.0).reshape(4, 3)
    assert coll.bcast(x, 0, ROW_AXIS, g) is x
    assert coll.bcast2d(x, (0, 0), g) is x
    assert coll.allreduce_sum(x, None, g) is x
    assert torch.equal(coll.allgather_tiles(x, COL_AXIS, g), x[None])


def test_take_tiles_clamps_out_of_range_ids():
    """torch.index_select raises on out-of-range ids where jnp.take does
    not: the port clamps them into range (junk rows its callers mask)."""
    tiles = torch.arange(3.0)[:, None, None].expand(3, 2, 2)
    got = panel.take_tiles(tiles, torch.tensor([-1, 0, 2, 5]))
    assert got[:, 0, 0].tolist() == [0.0, 0.0, 2.0, 2.0]
