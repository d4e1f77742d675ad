"""The port's copy of the block-cyclic index math and shard layout against
``dlaf_tpu.dist``.

The brute-force cases of tests/test_dist_index.py run on both packages
and must give equal outputs; the shard layout conversions run on numpy
arrays and on torch tensors.
"""
import numpy as np
import pytest
import torch

from dlaf_tpu.dist import Distribution as JaxDistribution
from dlaf_tpu.dist import gather_from_shards as jax_gather
from dlaf_tpu.dist import index as jix
from dlaf_tpu.dist import scatter_to_shards as jax_scatter
from dlaf_tpu_torch.dist import (Distribution, gather_from_shards, local_shard,
                                 scatter_to_shards)
from dlaf_tpu_torch.dist import index as ix


def _same(a, b):
    assert np.array_equal(np.asarray(a), np.asarray(b)), (a, b)


@pytest.mark.parametrize("grid,src", [(1, 0), (2, 0), (3, 1), (4, 3)])
def test_1d_conversions(grid, src):
    num_tiles = 17
    gts = np.arange(num_tiles + 1)
    for r in range(grid):
        for name, args in [("rank_global_tile", (gts, grid, src)),
                           ("local_tile_from_global_tile", (gts, grid)),
                           ("global_tile_from_local_tile", (gts, grid, r, src)),
                           ("next_local_tile_from_global_tile", (gts, grid, r, src)),
                           ("local_num_tiles", (num_tiles, grid, r, src))]:
            _same(getattr(ix, name)(*args), getattr(jix, name)(*args))
    # the brute-force model of tests/test_dist_index.py
    owners = [(t + src) % grid for t in range(num_tiles)]
    for r in range(grid):
        for gt in range(num_tiles + 1):
            assert ix.next_local_tile_from_global_tile(gt, grid, r, src) == \
                sum(1 for t in range(gt) if owners[t] == r)


@pytest.mark.parametrize("size,nb,grid", [(65, 8, 3), (64, 8, 2), (1, 4, 4), (0, 4, 2),
                                          (100, 7, 5)])
def test_local_size_numroc(size, nb, grid):
    for src in range(grid):
        for r in range(grid):
            got = int(ix.local_size(size, nb, grid, r, src))
            assert got == int(jix.local_size(size, nb, grid, r, src))
            assert got == sum(1 for el in range(size) if (el // nb + src) % grid == r)


def test_element_conversions():
    nb, grid, src = 8, 3, 1
    els = np.arange(100)
    for name, args in [("tile_from_element", (els, nb)),
                       ("tile_element_from_element", (els, nb)),
                       ("rank_global_element", (els, nb, grid, src)),
                       ("local_element_from_global_element", (els, nb, grid)),
                       ("tile_size_of", (els // nb, 100, nb))]:
        _same(getattr(ix, name)(*args), getattr(jix, name)(*args))
    for r in range(grid):
        _same(ix.global_element_from_local_element(els, nb, grid, r, src),
              jix.global_element_from_local_element(els, nb, grid, r, src))


def test_block_ne_tile_bruteforce():
    for grid in (1, 2, 3):
        for src in range(grid):
            for tpb in (1, 2, 4):
                ts = np.arange(24)
                _same(ix.rank_global_tile_b(ts, tpb, grid, src),
                      jix.rank_global_tile_b(ts, tpb, grid, src))
                _same(ix.local_tile_from_global_tile_b(ts, tpb, grid),
                      jix.local_tile_from_global_tile_b(ts, tpb, grid))
                for rank in range(grid):
                    for name in ("global_tile_from_local_tile_b",
                                 "next_local_tile_from_global_tile_b", "local_num_tiles_b"):
                        _same(getattr(ix, name)(ts, tpb, grid, rank, src),
                              getattr(jix, name)(ts, tpb, grid, rank, src))


@pytest.mark.parametrize("kw", [
    dict(size=(65, 33), block_size=(8, 8), grid_size=(3, 2), src_rank=(1, 0)),
    dict(size=(65, 33), block_size=(16, 8), grid_size=(3, 2), src_rank=(1, 0),
         tile_size=(4, 4)),
    dict(size=(64, 48), block_size=(8, 8), grid_size=(2, 3)),
    dict(size=(7, 7), block_size=(16, 16), grid_size=(2, 4))])
def test_distribution_2d(kw):
    d, j = Distribution(**kw), JaxDistribution(**kw)
    for attr in ("tile", "tiles_per_block", "nr_tiles", "nr_blocks",
                 "max_local_nr_tiles", "padded_size"):
        assert getattr(d, attr) == getattr(j, attr), attr
    P, Q = d.grid_size
    for i in range(d.nr_tiles[0]):
        for jj in range(d.nr_tiles[1]):
            t = (i, jj)
            assert d.rank_global_tile(t) == j.rank_global_tile(t)
            assert d.local_tile_index(t) == j.local_tile_index(t)
            assert d.tile_size_of(t) == j.tile_size_of(t)
            assert d.global_tile_from_local(d.local_tile_index(t), d.rank_global_tile(t)) == t
    for p in range(P):
        for q in range(Q):
            assert d.local_size((p, q)) == j.local_size((p, q))
            assert d.local_nr_tiles((p, q)) == j.local_nr_tiles((p, q))
            assert d.next_local_tile((3, 2), (p, q)) == j.next_local_tile((3, 2), (p, q))
    assert d.retiled(d.block_size) == Distribution(**{**kw, "tile_size": None})


def test_distribution_checks_and_sub_distribution():
    d = Distribution(size=(64, 64), block_size=(8, 8), grid_size=(2, 3))
    s = d.sub_distribution((16, 24), (32, 32))
    js = JaxDistribution(size=(64, 64), block_size=(8, 8),
                         grid_size=(2, 3)).sub_distribution((16, 24), (32, 32))
    assert (s.size, s.src_rank) == (js.size, js.src_rank)
    with pytest.raises(ValueError):
        d.sub_distribution((3, 0), (8, 8))
    for bad in [dict(size=(-1, 4)), dict(block_size=(0, 8)), dict(grid_size=(0, 1)),
                dict(src_rank=(2, 0)), dict(tile_size=(3, 8))]:
        with pytest.raises(ValueError):
            Distribution(**{**dict(size=(64, 64), block_size=(8, 8), grid_size=(2, 3)), **bad})


@pytest.mark.parametrize("as_torch", [False, True])
@pytest.mark.parametrize("lead", [(), (2,)])
def test_shard_layout(as_torch, lead):
    """scatter_to_shards / gather_from_shards on numpy arrays and torch
    tensors (with a leading batch dimension) equal the JAX package's."""
    d = Distribution(size=(64, 48), block_size=(8, 8), grid_size=(2, 3))
    jd = JaxDistribution(size=(64, 48), block_size=(8, 8), grid_size=(2, 3))
    pm, pn = d.padded_size
    a = np.arange(np.prod(lead + (pm, pn)), dtype=np.float64).reshape(lead + (pm, pn))
    want = jax_scatter(a, jd)
    x = torch.from_numpy(a) if as_torch else a
    shards = scatter_to_shards(x, d)
    assert isinstance(shards, torch.Tensor) == as_torch
    _same(shards, want)
    back = gather_from_shards(shards, d)
    _same(back, a)
    _same(back, jax_gather(want, jd))


def test_local_shard_is_one_shard_copied():
    d = Distribution(size=(64, 48), block_size=(8, 8), grid_size=(2, 3))
    pm, pn = d.padded_size
    a = torch.arange(pm * pn, dtype=torch.float32).reshape(pm, pn)
    shards = scatter_to_shards(a, d)
    for p in range(2):
        for q in range(3):
            s = local_shard(a, d, (p, q))
            assert torch.equal(s, shards[p, q]) and s.is_contiguous()
            assert s.untyped_storage().data_ptr() != a.untyped_storage().data_ptr()


def test_layout_rejects_wrong_shapes():
    d = Distribution(size=(64, 48), block_size=(8, 8), grid_size=(2, 3))
    with pytest.raises(ValueError, match="scatter_to_shards"):
        scatter_to_shards(np.zeros((64, 40)), d)
    with pytest.raises(ValueError, match="gather_from_shards"):
        gather_from_shards(np.zeros((2, 2, 32, 16)), d)
    with pytest.raises(ValueError, match="local_shard"):
        local_shard(torch.zeros(8, 8), d, (0, 0))
