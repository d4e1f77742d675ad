"""1-D block-cyclic index math.

A copy of :mod:`dlaf_tpu.dist.index` (which the port cannot import: the JAX
package's ``__init__`` imports jax). Pure-Python/NumPy port of the
conversion surface of the reference's
``include/dlaf/matrix/util_distribution.h`` (and the 1-D half of
``matrix/distribution.h:82-108``): every function works on Python ints or NumPy
integer arrays, so the same code serves host-side planning and vectorized
shard-index computation.

Conventions (all 0-based):
  - ``nb``      block/tile size along the dimension
  - ``grid``    number of ranks along the dimension (mesh axis size)
  - ``src``     rank owning the first tile (source rank offset)
  - ``rank``    the calling rank's coordinate along the dimension
  - "global tile"  index of a tile in the global matrix
  - "local tile"   index of a tile in a rank's local (packed) storage
"""
from __future__ import annotations

import numpy as np


def ceil_div(a, b):
    return -(-a // b)


# ---------------------------------------------------------------------------
# element <-> tile (reference util_distribution.h: tileFromElement etc.)


def tile_from_element(el, nb):
    return el // nb


def tile_element_from_element(el, nb):
    return el % nb


def element_from_tile_and_tile_element(tile, tile_el, nb):
    return tile * nb + tile_el


# ---------------------------------------------------------------------------
# tile <-> rank / local tile (reference: rankGlobalTile, localTileFromGlobalTile,
# globalTileFromLocalTile, nextLocalTileFromGlobalTile)


def rank_global_tile(global_tile, grid, src=0):
    """Rank owning ``global_tile`` under cyclic distribution."""
    return (global_tile + src) % grid


def local_tile_from_global_tile(global_tile, grid):
    """Local tile index on the owning rank."""
    return global_tile // grid


def global_tile_from_local_tile(local_tile, grid, rank, src=0):
    """Global tile index of local tile ``local_tile`` on ``rank``."""
    return local_tile * grid + (rank - src) % grid


def next_local_tile_from_global_tile(global_tile, grid, rank, src=0):
    """Index of the first local tile on ``rank`` with global index >= global_tile.

    Equals the number of global tiles < ``global_tile`` owned by ``rank``.
    """
    k = (rank - src) % grid
    return ceil_div(global_tile - k, grid)


def local_num_tiles(num_tiles, grid, rank, src=0):
    """Number of tiles owned by ``rank`` out of ``num_tiles`` global tiles."""
    return next_local_tile_from_global_tile(num_tiles, grid, rank, src)


def local_size(size, nb, grid, rank, src=0):
    """Number of *elements* owned by ``rank`` (ScaLAPACK ``numroc``)."""
    nt = ceil_div(size, nb)
    if np.ndim(nt) == 0 and nt == 0:
        return 0
    full = local_num_tiles(nt, grid, rank, src)
    # if this rank owns the last (possibly partial) tile, shrink its contribution
    last_owner = rank_global_tile(nt - 1, grid, src)
    last_sz = size - (nt - 1) * nb
    return full * nb - np.where(last_owner == rank, nb - last_sz, 0)


def tile_size_of(global_tile, size, nb):
    """Element extent of tile ``global_tile`` (last tile may be partial)."""
    nt = ceil_div(size, nb)
    last = size - (nt - 1) * nb
    return np.where(global_tile == nt - 1, last, nb)


# ---------------------------------------------------------------------------
# block != tile (multi-tile distribution blocks), reference
# util_distribution.h where every conversion takes ``tiles_per_block``:
# the *block* is the cyclic distribution unit, the *tile* the algorithmic
# unit, block = tiles_per_block * tile.


def rank_global_tile_b(global_tile, tpb, grid, src=0):
    """Rank owning ``global_tile`` when blocks span ``tpb`` tiles."""
    return (global_tile // tpb + src) % grid


def local_tile_from_global_tile_b(global_tile, tpb, grid):
    """Local tile index on the owner: whole local blocks before it, plus the
    tile's offset inside its block."""
    return (global_tile // tpb) // grid * tpb + global_tile % tpb


def global_tile_from_local_tile_b(local_tile, tpb, grid, rank, src=0):
    lb = local_tile // tpb
    return (lb * grid + (rank - src) % grid) * tpb + local_tile % tpb


def next_local_tile_from_global_tile_b(global_tile, tpb, grid, rank, src=0):
    """Number of global tiles < ``global_tile`` owned by ``rank``."""
    b = global_tile // tpb
    k = (rank - src) % grid
    full = ceil_div(b - k, grid) * tpb
    own_b = (b + src) % grid == rank % grid
    return full + np.where(own_b, global_tile % tpb, 0)


def local_num_tiles_b(num_tiles, tpb, grid, rank, src=0):
    return next_local_tile_from_global_tile_b(num_tiles, tpb, grid, rank, src)


# ---------------------------------------------------------------------------
# element-level distributed conversions


def rank_global_element(el, nb, grid, src=0):
    return rank_global_tile(tile_from_element(el, nb), grid, src)


def local_element_from_global_element(el, nb, grid):
    """Local element offset of a globally-indexed element on its owner rank."""
    gt = tile_from_element(el, nb)
    return local_tile_from_global_tile(gt, grid) * nb + tile_element_from_element(el, nb)


def global_element_from_local_element(lel, nb, grid, rank, src=0):
    lt = lel // nb
    return global_tile_from_local_tile(lt, grid, rank, src) * nb + lel % nb
