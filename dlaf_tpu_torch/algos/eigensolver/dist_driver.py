"""Distributed hermitian eigensolver driver.

PyTorch counterpart of :mod:`dlaf_tpu.algos.eigensolver.dist_driver`
(reference distributed ``Eigensolver<B,D,T>::call``,
``eigensolver/eigensolver/impl.h:57-95``, and ``GenEigensolver::call``).
Every rank of the grid calls the entry points on its shards; no stage
gathers the matrix:

  - stage 1 (reduction to band, ~4n^3/3 flops): distributed on the 2-D
    grid (:mod:`.dist_red2band`);
  - band extraction: one allreduce into replicated strip storage
    (:func:`.dist_stage23.strips_from_packed_dist`);
  - stage 2 (band -> tridiagonal): every rank chases the O(n*b) band,
    through kernel K3 on the card in f32 and complex64, and records its
    own sweep chunk of the O(n^2) reflector record (or the sweeps are
    pipelined over the ranks, ``band_to_tridiag_dist_mode``);
  - stage 3 (tridiagonal D&C): distributed merges (:mod:`.tridiag_dc_dist`);
  - both back-transformations on column shards of the eigenvectors,
    reflector groups summed over the grid, all products local;
  - one tile-slot all-to-all into the block-cyclic layout.

Per-rank memory: O(n^2/PQ + n*b). Rank counts that are not a power of two
run the D&C merge tree on the largest power-of-two subset. Only more ranks
than the padded size go through the gathered route
(:func:`_eigh_dist_gathered`).
"""
from __future__ import annotations

import logging
import math

import torch

from ...dist import Distribution
from ...matrix.dist_matrix import DistMatrix
from ...tune import get_tune_parameters
from .band2tridiag import band_to_tridiag_auto
from .bt import bt_band_to_tridiag, bt_reduction_to_band
from .dist_red2band import reduction_to_band_dist
from .driver import _phase_normalize, _real, get_band_size, pad_dense
from .red2band import extract_band
from .tridiag_dc import tridiag_eigh
from .tridiag_dc_dist import (dc_dist_supported, merge_tree_idle_fraction, pow2_floor,
                              tridiag_eigh_dist)
from . import dist_stage23 as s23


def _square_lattice(a: DistMatrix) -> DistMatrix:
    """Embed the canonical shards in a square padded lattice (pm == pn).

    ``Distribution.padded_size`` rounds rows up by P*nb and columns by
    Q*nb, so on grids with P != Q a square matrix can get a non-square
    lattice, where the decoupled padding diagonal (rows/cols n..pm) would
    not fit. Padding every shard with whole zero tiles up to the
    lcm(P, Q)-aligned square lattice is a local pad: no data moves.
    """
    P, Q = a.grid.grid_size
    mb, nb = a.dist.block_size
    lmt, lnt = a.dist.max_local_nr_tiles
    lc = math.lcm(P, Q)
    mt = -(-max(lmt * P, lnt * Q) // lc) * lc
    if (mt * nb, mt * nb) == a.dist.padded_size:
        return a
    data = a.data.new_zeros(((mt // P) * mb, (mt // Q) * nb))
    data[:a.data.shape[0], :a.data.shape[1]] = a.data
    return DistMatrix(data, Distribution((mt * nb, mt * nb), (nb, nb), a.grid.grid_size),
                      a.grid)


_GATHERED_WARNED = [False]
_IDLE_WARNED = [False]


def _pad_fixed(a: DistMatrix, n: int) -> DistMatrix:
    """``a`` on its square lattice with the padding fixed (``_pad_fix``)."""
    data = s23._pad_fix(a.data, nb=a.block_size, n=n, pm=a.dist.padded_size[0], grid=a.grid)
    return DistMatrix(data, a.dist, a.grid)


def eigh_dist(a: DistMatrix, laed4_iter: int | None = None):
    """Eigen-decomposition of a distributed hermitian matrix (lower
    triangle stored; ``a`` is not written). Every rank of the grid calls
    it.

    Returns (w (n,) replicated, ascending; v DistMatrix of the
    eigenvectors over the same grid and distribution).
    """
    n = a.dist.size[0]
    tune = get_tune_parameters()
    laed4 = laed4_iter or tune.laed4_max_iter
    D = a.grid.size
    orig_dist = a.dist
    a_sq = _square_lattice(a)
    pm = a_sq.dist.padded_size[0]
    if not dc_dist_supported(pm, D):
        return _eigh_dist_gathered(a, laed4)
    if D != pow2_floor(D) and not _IDLE_WARNED[0]:
        _IDLE_WARNED[0] = True
        if a.grid.rank == 0:
            print(f"dlaf_tpu_torch: {D}-rank grid is not a power of two; the "
                  f"stage-3 merge tree runs on {pow2_floor(D)} ranks "
                  f"({merge_tree_idle_fraction(D):.0%} idle during that stage "
                  f"only; all other stages use all {D})")
    grid = a.grid
    nb = a_sq.block_size
    band = get_band_size(nb)
    dt_ = a_sq.data.dtype

    packed, taus1 = reduction_to_band_dist(_pad_fixed(a_sq, n), band)
    strips = s23.strips_from_packed_dist(packed, band)
    d, e, vs, taus2 = s23.band_to_tridiag_dist(strips, pm, band, grid)
    del strips
    er, phases = _phase_normalize(e, dt_)
    w, qc, m = tridiag_eigh_dist(_real(d), er, grid, laed4, col_align=nb)
    qc = qc.to(dt_)
    if qc.is_complex():
        ph = torch.cat([phases, phases.new_ones((m - pm,))])
        qc = ph[:, None] * qc
    qc = s23.bt_band_to_tridiag_dist(qc, vs, taus2, band, pm, grid,
                                     group_size=tune.bt_band_to_tridiag_hh_apply_group_size)
    del vs, taus2
    qc = s23.bt_reduction_to_band_dist(qc, packed, taus1, band)
    vdata = s23.cols_to_canonical(qc, dist=orig_dist, grid=grid)
    return w[:n], DistMatrix(vdata, orig_dist, grid)


def _eigh_dist_gathered(a: DistMatrix, laed4: int):
    """The route for more ranks than the padded problem size, which the
    distributed D&C cannot shard: distributed stage 1, stages 2 to 5 on
    the gathered matrix on every rank."""
    if not _GATHERED_WARNED[0]:
        _GATHERED_WARNED[0] = True
        logging.getLogger("dlaf_tpu_torch").warning(
            "eigh_dist: %d ranks exceed the padded problem size, which the "
            "distributed D&C cannot shard; running the gathered stages 2-5 "
            "instead: expect a large per-rank memory/latency cliff", a.grid.size)
    n = a.dist.size[0]
    nb = a.block_size
    pm = a.dist.padded_size[0]
    grid = a.grid
    if pm > n:
        a = DistMatrix.from_global(pad_dense(a.to_global(), pm), nb, grid)
    packed, taus1 = reduction_to_band_dist(a)
    packed_g = packed.to_global()
    d, e, vs, taus2 = band_to_tridiag_auto(extract_band(packed_g, nb), nb)
    er, phases = _phase_normalize(e, packed_g.dtype)
    w, q = tridiag_eigh(_real(d), er, laed4)
    q = phases[:, None] * q.to(packed_g.dtype)
    q = bt_band_to_tridiag(q, vs, taus2, nb)
    q = bt_reduction_to_band(q, packed_g, taus1, nb)
    return w[:n], DistMatrix.from_global(q[:n, :n], nb, grid)


def eigvalsh_dist(a: DistMatrix, laed4_iter: int | None = None):
    """Distributed eigenvalues only: both back-transformations and the
    final exchange are skipped (reference ``hermitian_eigensolver`` with
    eigenvalues-only allocation, ``eigensolver/eigensolver.h:56``)."""
    n = a.dist.size[0]
    laed4 = laed4_iter or get_tune_parameters().laed4_max_iter
    a_sq = _square_lattice(a)
    pm = a_sq.dist.padded_size[0]
    if not dc_dist_supported(pm, a.grid.size):
        return _eigh_dist_gathered(a, laed4)[0]
    band = get_band_size(a_sq.block_size)
    packed, _ = reduction_to_band_dist(_pad_fixed(a_sq, n), band)
    strips = s23.strips_from_packed_dist(packed, band)
    d, e, _, _ = s23.band_to_tridiag_dist(strips, pm, band, a.grid)
    er, _ = _phase_normalize(e, a.data.dtype)
    w, _, _ = tridiag_eigh_dist(_real(d), er, a.grid, laed4)
    return w[:n]


def eigh_gen_dist(a: DistMatrix, b: DistMatrix, laed4_iter: int | None = None,
                  b_factorized: bool = False):
    """Distributed generalized eigensolver A x = lambda B x: cholesky ->
    gen_to_std -> eigh_dist -> triangular back-solve, each the distributed
    implementation (reference ``gen_eigensolver/impl.h:46-93``). Only the
    lower triangles of ``a`` and ``b`` are read; ``b`` is padded with
    identity. With ``b_factorized`` (the reference's
    ``already_factorized``), ``b`` already holds the Cholesky factor L.
    Returns (w, x DistMatrix) with X^H B X = I.
    """
    from ..cholesky import cholesky
    from ..gen_to_std import generalized_to_standard_dist
    from ..triangular import triangular_solver

    l = b if b_factorized else cholesky(b)
    afull = a.symmetrize(lower=True)
    astd = generalized_to_standard_dist(afull, l)
    del afull
    w, z = eigh_dist(astd, laed4_iter)
    del astd
    return w, triangular_solver(l, z, uplo="L", trans="C")
