"""Smoke run of the PyTorch/H100 port (dlaf_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the Hopper kernels from ``dlaf_tpu_torch/csrc`` (nvcc, at first
use), holds each kernel against its plain PyTorch version at the shapes
the main path gives it (K1, the cluster tile factor, at nb = 64 up to its
largest 1808; K2, the 3xTF32 tensor-core update, beside its one- and
two-term TF32 splits as planted faults that its bound must reject), then
drives the main path, the local Cholesky
``dlaf_tpu_torch.potrf`` at n = 32768 f32 (the headline configuration of
``bench.py``), through the kernels and through the plain route, and checks
the factor's residual and the kernel route's factor against the plain
route's, entry by entry. Each factor check is also shown a planted fault
(one slab update skipped), which it must reject. Then the Cholesky miniapp with ``--check``, and
``potrf_info`` on a matrix that is not positive definite.

The eigensolver slice: K3 (stage-2 bulge chasing) against its plain
version on f32 and complex64 bands, ragged and sweep-chunked, each of its
two instances (the chase's window resident in shared memory, or streamed
from L2) in both dtypes, on the bands
the main path hands it (n = 8192 f32 and 4096 complex64), and on a band
whose lanes outnumber the blocks co-resident on the card, beside planted
faults (one chase's update skipped) and with bit-identical repeats (the
host-bound f64 references and planted faults of a case run in two worker
processes beside the main one);
then ``dlaf_tpu_torch.eigh`` at n = 8192 f32, band 128 (the ``heev``
configuration of ``scripts/bench_sections.py``), timed whole and by stage
(the staged run held bit-equal to the entry point's eigenvalues),
its eigenvectors held to orthogonality and residual bounds and its
eigenvalues to ``torch.linalg.eigvalsh`` in f64 (a yardstick the port never
calls), each bound beside a planted fault; complex64 ``eigh`` at n = 4096;
and the eigensolver miniapp with ``--check`` in s and d.

The ``eigh_large`` slice: K4 and K5 (the streaming stage-4 apply, 3xTF32
on the tensor cores) against their plain versions on random WY blocks (the
main path's band and width, ragged widths, phantom groups, nact = 0), each
beside a planted fault, the main path's width also beside the one- and
two-term TF32 splits, and with bit-identical repeats; then
``dlaf_tpu_torch.eigh_large`` at
n = 32768 f32, band 128 (the ``heev_32768`` configuration of
``scripts/bench_sections.py``), timed whole and by stage with each stage's
peak memory, held to the bench's probe gates and a trace gate, each beside
a planted fault; its stage 4 through K5 against the cooked cuBLAS route and
against K4/K5's plain versions on the same record, K5's heaviest step (also
beside the one- and two-term TF32 splits) and one K4 group on that record
held to their plain versions and timed; and
``eigh_large`` against ``dt.eigh`` at n = 9984 (K4 and K5; the peeled K4
call with the most chases held to its plain version on the buffer it was
given), 2048 in three re-chased chunks and complex64 4096.

The distributed slice: K6 (the masked trailing update, K2's 3xTF32
tensor-core kernel with a mask) against its plain
version at the shapes the distributed Cholesky gives it at n = 32768 (the
heaviest lower and upper staircase chunks, a panel-step update with
sentinel columns), on the index pattern of a 2x2 grid with ragged,
row-strided views, through the split-k cluster path, and on inputs whose
tiles are all dead, each check beside a planted fault, the heaviest chunks
also beside the one- and two-term TF32 splits under the mask, with
bit-identical repeats, the heaviest chunk timed against cuBLAS's unmasked
``addmm``;
then ``dlaf_tpu_torch.cholesky`` on a 1x1 grid at n = 32768 f32, nb = 512
(``scripts/bench_dist.py``'s configuration), L then U, in turns through
K1 + K6 and the plain route, held to the residual and route gates (each
beside a planted fault) with the other triangle bit-equal to the input,
beside the local ``potrf``; and a 2x2 grid of four gloo ranks on the one
card (``spawn_grid``) at n = 8192, L and U, K6 launched on every rank, the
gathered factors against the 1x1 grid's entry by entry, ``cholesky_info``
on a planted pivot and the distributed miniapp with ``--check``.

The rest of the local API, in f32 with nb = 512: every side/uplo/trans/
diag case of ``trsm`` and ``trmm`` at (2048, 1024) against f64; ``trsm``
and ``trmm`` (side L, uplo L) at A 32768 x 32768, B 32768 x 16384 and
``trsm`` on the right once, ``hegst`` at n = 32768 against the K1 factor
of an SPD B, and ``herk`` U/C (alpha -1, beta 1) at n = k = 16384 through
K2 and on the plain route, each timed beside a library yardstick and held
to f64 beside a planted fault (a skipped leaf solve or leaf multiply, K2
cut to one TF32 term); then ``eigh_gen`` at n = 8192, band 128, timed
whole and by stage (potrf through K1, the two solves of ``hegst``, ``eigh``
through K3, the back-solve; the staged run bit-equal to the entry point's)
beside the library route, its residual and B-orthogonality gates beside a
perturbed factor of B, and the triangular solver, triangular
multiplication, gen_to_std and generalized eigensolver miniapps with
``--check``.

The stage miniapps and the distributed BLAS-3: the five stage miniapps
(reduction to band, band to tridiagonal through K3, tridiagonal solver,
both back-transformations) with ``--check`` at n = 8192 f32, band 128, and
``kernel_runner`` at nb = 512 (``potrf``: 64 K1 launches a run, its batch
held to K1's plain version; ``ksub``: one K2 launch, held to K2's; beside
planted faults); the distributed ``triangular_solver`` (left, and right
once), ``general``, ``hermitian`` and ``triangular_multiplication`` at A
32768 x 32768, B 32768 x 16384 and ``generalized_to_standard_dist`` at
n = 32768 on a 1x1 grid, each timed beside its local counterpart and held
to f64 beside a planted fault (a skipped diagonal-tile solve or k panel;
a transpose missing its conjugate on a complex64 case) and beside its
products in TF32, ``max_norm`` and
``permute`` bit-equal to the local ones; and four gloo ranks on the card
(2x2 at n = 8192, 1x4 at n = 4096) against the 1x1 grid's results,
``ring_shift``, and the three distributed miniapps with ``--check``.

The distributed eigensolver: ``eigh_dist`` on a 1x1 grid at ``eigh``'s
configuration (n = 8192 f32, nb = 512, band 128) in turns with ``eigh``,
K3 counted on its replicated stage 2, timed by stage (the staged run
bit-equal to the entry point's eigenvalues), its orthogonality, residual
and eigenvalue gates each beside a planted fault (one stage-4 reflector
group skipped, one stage-1 reflector not unitary, one subdiagonal entry
lost), the device's idle share of one call under ``torch.profiler``;
``eigvalsh_dist``; ``eigh_gen_dist`` in turns with ``eigh_gen`` beside a
perturbed factor of B; complex64 ``eigh_dist`` at n = 4096 (K3's streamed
instance); then four gloo ranks on the card: ``eigh_dist`` on 2x2 and 1x4
grids in the replicated stage 2 (K3 once on every rank, d and e equal on
every rank) and the pipelined one, ``eigh_gen_dist`` on 2x2, each against
the 1x1 grid's result, and the seven eigensolver miniapps' distributed
branches with ``--check``. K3's sweep-chunked cases include the last
rank's chunk of four, whose sweeps past the end must read tau = 0, and
``potrf_info`` also meets a NaN entry, the kernel route's info recorded
beside the plain route's.

The user surfaces: the ScaLAPACK-style entries on a 1x1 grid at the main
path's sizes, each beside its driver on a DistMatrix
(``dlaf_pspotrf`` n = 32768 L and U through K1 and K6, ``dlaf_pssyevd``
n = 8192 through K3, ``dlaf_pssygvd`` and its ``_factorized`` form,
``dlaf_pcheevd`` n = 4096, a tile-aligned sub-matrix call), each held to
its driver's gates beside a planted fault (a factor column x 1.5, a
stage-4 reflector group skipped) with the other triangle bit-equal to the
input, and ``c_ppotrf``'s info on a non-SPD sub-block; the C API from
plain C (the shim built from the checkout, the port's card driver at
n = 32768 and 8192, checked in C, and the JAX package's
``tests/c_api_main.c`` unchanged as four gloo ranks on the card); then
``miniapp_communication`` on 1x1 and 2x2, the eigensolver miniapp writing
``--output-file`` and reading it back with ``--input-file --check`` at
n = 8192, ``from_callback``/``sub_matrix``/``set_sub_matrix`` bit-equal to
``from_global`` and slicing at n = 32768 (1x1) and 8192 (2x2),
``Grid.multihost``, the ScaLAPACK entries on a 2x2 context and
``initialize(print_config=True)``.

The collective-schedule checker (``dlaf_tpu_torch.debug``): inside the two
existing spawns of four gloo ranks, ``cholesky`` L and U at n = 8192
(K1 on the ranks that hold diagonal tiles, K6 on every rank) and
``eigh_dist`` on 2x2 at n = 2048 in the replicated stage 2 (K3 once a
rank) run once more under ``record_schedule(check=True)``: no finding and
the same schedule length on every rank, each checked run's seconds beside
the unchecked run of the same call. On the 2x2 ranks three planted
divergences must come back as their findings within seconds: one rank's
extra ``allreduce_sum`` after ``cholesky`` (``while-collective``), one
rank skipping one step's panel ``bcast`` (``cond-divergent``) and one
rank's shard swap of ``DistMatrix.transpose`` posted after an extra group
collective (``p2p-unpaired``); and a planted stall, rank 0 reaching a sum
over the grid 3 s late against a checker timeout cut to 2 s, must come
back as three identical ``stalled ... for ranks [0]`` findings on every
rank, one from each rank that waited.

Every phase prints one JSON line. Any failed check raises, so the exit code
is not 0; nothing catches it. The last lines are the card's
``nvidia-smi`` name and power limit, one JSON line with the kernels, and
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
with code 1 before it prints any result.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import gc
import io
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
    sys.exit(1)

import dlaf_tpu_torch as dt  # noqa: E402
from dlaf_tpu_torch.algos.eigensolver import band2tridiag as b2t  # noqa: E402
from dlaf_tpu_torch.algos.eigensolver import band_strips as bs  # noqa: E402
from dlaf_tpu_torch.algos.eigensolver.band2tridiag import (  # noqa: E402
    band_to_tridiag_auto, band_to_tridiag_pipelined)
from dlaf_tpu_torch.algos.eigensolver.bt import (  # noqa: E402
    bt_band_to_tridiag, bt_band_to_tridiag_sweepwise, bt_reduction_to_band)
from dlaf_tpu_torch.algos.eigensolver.driver import _phase_normalize  # noqa: E402
from dlaf_tpu_torch.algos.eigensolver.red2band import (  # noqa: E402
    extract_band, reduction_to_band)
from dlaf_tpu_torch.algos.eigensolver import large  # noqa: E402
from dlaf_tpu_torch.algos.eigensolver import dist_driver as ddrv  # noqa: E402
from dlaf_tpu_torch.algos.eigensolver import dist_red2band  # noqa: E402
from dlaf_tpu_torch.algos.eigensolver import dist_stage23 as s23  # noqa: E402
from dlaf_tpu_torch.algos.eigensolver.tridiag_dc_dist import tridiag_eigh_dist  # noqa: E402
from dlaf_tpu_torch.algos.eigensolver import red2band as r2b  # noqa: E402
from dlaf_tpu_torch.algos.eigensolver.tridiag_dc import tridiag_eigh  # noqa: E402
from dlaf_tpu_torch.comm.launch import spawn_grid  # noqa: E402
from dlaf_tpu_torch.comm.mesh import ROW_AXIS  # noqa: E402
from dlaf_tpu_torch.matrix import generators as gen  # noqa: E402
from dlaf_tpu_torch.matrix.dist_matrix import global_indices  # noqa: E402
from dlaf_tpu_torch.api.local import _pad_zero, _tri_operand  # noqa: E402
from dlaf_tpu_torch.algos import general  # noqa: E402
from dlaf_tpu_torch.algos.norm import max_norm_local  # noqa: E402
from dlaf_tpu_torch.algos.permutations import permute_local  # noqa: E402
from dlaf_tpu_torch.comm import collectives as coll  # noqa: E402
from dlaf_tpu_torch.miniapps import (  # noqa: E402
    kernel_runner, miniapp_band_to_tridiag, miniapp_bt_band_to_tridiag,
    miniapp_bt_reduction_to_band, miniapp_cholesky, miniapp_eigensolver,
    miniapp_gen_eigensolver, miniapp_gen_to_std, miniapp_reduction_to_band,
    miniapp_triangular_multiplication, miniapp_triangular_solver, miniapp_tridiag_solver)
from dlaf_tpu_torch.ops import blocked, leaf  # noqa: E402
from dlaf_tpu_torch.ops.kernels import _build  # noqa: E402
from dlaf_tpu_torch.ops.core import ct, hermitian_from_tri_, symmetrize_tri  # noqa: E402
from dlaf_tpu_torch.ops.kernels.potrf import (  # noqa: E402
    NB_MAX, factor_deviation, potrf_tile, potrf_tile_plan, potrf_tile_ref)
from dlaf_tpu_torch.ops.householder import householder_vector  # noqa: E402
from dlaf_tpu_torch.ops.kernels.band2tridiag import (  # noqa: E402
    band_to_tridiag_strips_kernel, band_to_tridiag_strips_ref, chase_instance, chase_plan,
    device_smem_optin, resident_smem_bytes, wavefront_steps)
from dlaf_tpu_torch.ops.kernels.trailing import (  # noqa: E402
    ksub_matmul, ksub_matmul_masked, ksub_matmul_masked_ref, ksub_matmul_masked_split_ref,
    ksub_matmul_plan, ksub_matmul_ref, ksub_matmul_split_ref)
from dlaf_tpu_torch.algos.eigensolver import bt as btm  # noqa: E402
from dlaf_tpu_torch.ops.kernels.bt_apply import (  # noqa: E402
    bt_apply_fused, bt_apply_fused_ref, bt_apply_fused_split_ref, bt_apply_group,
    bt_apply_group_ref, bt_apply_group_split_ref)
from dlaf_tpu_torch.types import eps  # noqa: E402
from dlaf_tpu_torch import debug, init as dinit, native  # noqa: E402
from dlaf_tpu_torch.api import scalapack as sl  # noqa: E402
from dlaf_tpu_torch.matrix import io as mio  # noqa: E402
from dlaf_tpu_torch.miniapps import miniapp_communication  # noqa: E402
from dlaf_tpu_torch.native import c_entry  # noqa: E402

DEV = torch.device("cuda", 0)
N_MAIN, NB_MAIN = 32768, 512
EPS32 = eps(torch.float32)
# leaf sizes of the main path and the bench; 1024 and NB_MAX (K1's largest)
# keep the working tile in device memory
K1_NBS = (64, 128, 256, 512, 1024, NB_MAX)
# Factor checks, per entry (factor_deviation <= 1): |got - want| <= C eps32
# (|want| + max off-diagonal |want|), plus half a bf16 ulp for bf16. On an
# H100, sound f32 factors read at most 3.5 in units of eps32 (|want| + max
# off-diagonal |want|): K1 against cholesky_ex at nb = 64..512, and the
# kernel route's n = 32768 factor against the plain route's (3.3). One
# skipped slab update reads 1.1e3 times K1's bound or more, and, in one
# leaf of the n = 32768 POTRF, 760 in those units (47 times ROUTE_C's
# bound). Every K1 case and the full-size POTRF are checked beside such a
# planted fault, which the check must reject.
K1_C, ROUTE_C = 32, 16
K1_BOUND = f"|got-want| <= {K1_C} eps32 (|want| + max offdiag |want|) [+ bf16 ulp/2]"
# the residual's second bound: max|U^T U - A| <= RES_K eps32 max|A| (sound
# runs read 3.0 at n = 32768; a "factor" that is only the square root of
# the diagonal reads about 256 there)
RES_K = 16
# (m, n, k, x_k_major, leading-dimension pad): main-path trailing shapes,
# both layouts, and ragged row-strided views that are not 16-byte aligned
# (512-wide blocks and the 300 x 200 case take the cluster split of k)
K2_CASES = [(512, 512, 512, True, 0), (512, 512, 16384, True, 0),
            (4096, 4096, 8192, True, 0), (8192, 8192, 16384, True, 0),
            (8192, 8192, 16384, False, 0), (1000, 777, 1234, True, 3),
            (1000, 777, 1234, False, 5), (300, 200, 5000, False, 2)]
K2_TIMED = (8192, 8192, 16384)          # the largest trailing update at n = 32768
# timed: the largest update, and a deep level's 512 x 512 block with the
# longest k (the cluster split of k)
K2_TIMES = [K2_TIMED, (512, 512, 16384)]
GEMM_N = 16384
MINIAPP_N = "8192"
KERNELS = {}   # name -> the entry of the kernels line
# the card's published peaks (NVIDIA H100 SXM data sheet, 700 W): f32 FFMA
# rate outside the tensor cores and HBM bandwidth, for each kernel's bound;
# the TF32 tensor-core rate, which K2's three passes share
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
PEAK_TF32 = 495e12
# K3 cases on random bands: (n, b, dtype, sweep_lo, sweep_chunk); the main
# path's band width, a narrow band, b > 128, a ragged n, a sweep-chunked
# record, the last rank's chunk of eigh_dist's replicated stage 2 on four
# ranks (1022 sweeps in chunks of 256: its last two sweeps lie past the
# end and must read tau = 0), and complex64 at b = 64, so that each instance of the kernel
# (resident: the window in shared memory; streamed: in L2) meets each
# dtype. Then K3 on the main path's own inputs (the bands
# stage 1 hands it in eigh_main and eigh_c64, K3_MAIN), and on a narrow band
# long enough that its lanes outnumber the blocks co-resident on the card,
# so that a block takes several lanes per wavefront step (K3_MULTI_B).
K3_CASES = [(1024, 128, torch.float32, 0, None), (1024, 128, torch.complex64, 0, None),
            (300, 16, torch.float32, 0, None), (200, 160, torch.float32, 0, None),
            (777, 32, torch.float32, 0, None), (1024, 128, torch.float32, 200, 128),
            (1024, 128, torch.float32, 768, 256), (512, 64, torch.complex64, 0, None)]
K3_MULTI_B = 8
K3_PLAIN_TIMED = (1024, 128)    # the sequential plain version is timed where it is affordable
K3_PLANTED = (300, 16)          # the small case a planted fault is shown on
# K3's plain version is the sequential strip chase up to n = K3_SEQ_MAX;
# beyond, where that takes minutes, the batched dense chase
# band_to_tridiag_pipelined, which computes the same function
K3_SEQ_MAX = 1024
# K3 against its plain version. A tridiagonal reduction is not forward
# stable entry by entry: where a reflector's head x0 is near 0 its sign may
# go either way, which flips the signs of e and of later reflectors, and
# later entries are Lanczos coefficients, sensitive to rounding. So each
# case is held to backward errors, in units of eps32 ||B||_2, each at most
# K3_EIG (K3_RES) times the plain version's own reading on the same band
# (floor 1): the plain version sets the level the case's conditioning
# allows, and it grows with the number of chases that touch an entry (the
# plain version reads 1.3 at n = 8192, b = 128 and 16.6 at n = 4754, b = 8):
#  - eig: the eigenvalues of the tridiagonal against those of the band, f64;
#  - res: the reflector record, with Q applied from K3's own vs and taus
#    (f64), max|B Q - Q T|;
#  - rel: d and |e| (which do not see those signs) against the plain
#    version's in f64, over the plain version's own f32 distance from them,
#    that denominator clamped to [1, K3_REL_CAP] n eps32 max(1, max|A|):
#    <= K3_REL. It asks whether K3 lands as near the f64 result as the
#    plain f32 run does; the cap keeps a large inherent distance from
#    widening the bound without limit. rel is a coarse check and not a pass
#    criterion on its own: a skipped chase update at n = 8192 moves d and |e|
#    by only a few times their f32 rounding noise, and eig and res are the
#    checks that reject it;
#  - a sweep-chunked record bit-equal to the same rows of K3's full record.
# The card's readings: sound cases read eig 0.61-21.6 (0.72-1.25 times the
# plain version's), res 0.96-6.2 (0.71-1.33 times) and rel 0.08-7.5 (the
# highest where the cap binds: n = 4754, b = 8, where the plain f32 run lies
# 215 n eps32 max(1, max|A|) from f64); a skipped chase update reads eig 6195 at n = 8192 (4800
# times the plain version's) and 9.0e4 at n = 300, a lost tau res 5.1e5 and
# 1.3e6.
K3_REL = 16.0
K3_REL_CAP = 100.0
K3_EIG = 4.0
K3_RES = 4.0
# K4/K5 cases: (kind, b, nev, blocks in the buffer, (base, ncvalid) for K4
# or (beta, nact, v0p) for K5, k). The main path's band 128 at its width
# nev = 32768, ragged nev, base_blk > 0 with ncvalid < ncmax, k = 2 and 8,
# phantom groups (nact < k), nact = 0, and a narrower band.
K45_CASES = [("K4", 128, 32768, 10, (0, 8), None), ("K4", 128, 1000, 9, (2, 5), None),
             ("K5", 128, 32768, 14, (1, 8, 4), 8), ("K5", 128, 777, 8, (1, 1, 4), 2),
             ("K5", 128, 4096, 12, (2, 5, 3), 8), ("K5", 128, 4096, 6, (2, 0, 3), 8),
             ("K5", 128, 2048, 8, (0, 2, 4), 2), ("K4", 64, 300, 12, (1, 9), None),
             ("K5", 64, 300, 12, (0, 4, 5), 4)]
# K4/K5 against the plain version, max|got - want| / (eps32 max|E|). The
# card's readings of the 3xTF32 kernels: 12-45 over the cases, 5.0 on the
# real record's K4 group and K5 step; their one- and two-term TF32 splits
# read 1.5e4-5.6e4 on the cases and 4.5e3-5.3e3 on the real step, and one
# chase's V2 scaled by 1.1 reads 1.9e6 or more
K45_BOUND = 64.0
K45_REPLACES = {"bt_apply_group": "dlaf_tpu/ops/pallas/bt_apply.py:187",
                "bt_apply_fused": "dlaf_tpu/ops/pallas/bt_apply.py:375"}
# eigh_large: the contract scale of scripts/bench_sections.py heev_32768
N_LARGE, B_LARGE, LARGE_SEED = 32768, 128, 13
# its probe gates (scripts/bench_sections.py:443-457: four random unit
# probes u, orth = max|V^T V u - u| in units of n eps32, res = max|A V u -
# V diag(w) u| in units of n eps32 max(1, max|A|)) and the trace gate
# |sum(w) - tr(A)| in units of n eps32 max|A|. The bench's own gates are
# 500 and 1000; the bounds here are set from the card's readings: sound
# runs read orth 1.3e-4 to 2.8e-4, res 0.0099, trace 75.7; a dropped stage-2 tau reads
# res 45, a stage-1 tau scaled by 1.1 orth 0.10 (and trace only 97: the
# trace barely sees a non-unitary reflector), so the trace gate is shown
# one tridiagonal diagonal entry off by 2 instead.
LARGE_BOUNDS = {"orth": 0.01, "res": 0.5, "trace": 150.0}
# the planted faults run as whole eigh_large calls at this n (the readings
# above are from n = 32768, where each call took ~30 s; the gates' units
# scale with n)
N_PLANTED_LARGE = 8192
# the whole stage 4 through K4/K5 against the cooked cuBLAS route and
# against K4/K5's plain versions on the same record, max|diff| / (eps32
# max|E|): the card reads 18.0 and 18.1 at n = 32768 (32,896 chases) through
# the 3xTF32 kernels; a dropped reflector moves E by O(1) (the res gate's
# planted fault reads 45 n eps there)
STAGE4_BOUND = 64.0
# eigh_large against dt.eigh: (n, rec_chunks, dtype); n = 9984 runs 6
# groups through K4 and 72 in 9 K5 steps, n = 2048 in three chunks
# overshoots the band end by 2b + 2 (the abs0 clamp, phantom groups, the
# re-chase), complex64 takes the cooked route
LARGE_CASES = [(9984, 1, torch.float32), (2048, 3, torch.float32), (4096, 1, torch.complex64)]
N_EIGH, B_EIGH, N_EIGH_C = 8192, 128, 4096
EIGH_SEED = {torch.float32: 11, torch.complex64: 12}
K3_MAIN = [(N_EIGH, torch.float32), (N_EIGH_C, torch.complex64)]
# eigh gates beside the miniapp's (orth <= 500 n eps, res <= 1000 n eps
# max|A|): orth in units of n eps, residual and eigenvalues (against
# torch.linalg.eigvalsh in f64) in units of n eps max|A|, set from the
# card's readings: sound f32 n = 8192 reads 0.014, 0.050 and 0.91, complex64
# n = 4096 0.025, 0.070 and 1.31; the planted faults read 1.15, 4157 and 54
EIGH_BOUNDS = {"orth": 0.2, "res": 1.0, "eig": 10.0}
# K6 and the distributed Cholesky. The distributed POTRF at n = 32768,
# nb = 512 on a 1x1 grid (panel width 2048 = 4 tiles, 24 trailing chunks)
# gives K6 48 panel-step updates and 255 staircase chunks per factor; the
# heaviest chunk has rows from tile 4 on, columns of tiles 4..6 and k = 4
# tiles: (m, n, k) = (30720, 1536, 2048)
K6_CHUNK = (30720, 1536, 2048)
K6_SENTINEL = 2**30
# the routes in turns (runs 0 and 1 are each route's warm-up), as phase_main
ROUTE_TURNS = ["kernel", "torch", "torch", "kernel", "kernel", "torch"]
# the 2x2 grid of four gloo ranks sharing the one card: n, the input's
# seed, the planted non-positive pivot of cholesky_info, and the
# distributed miniapp's run
N_GRID, GRID_SEED, GRID_BAD = 8192, 6, 2500
# the rest of the local API: trsm/trmm at A 32768 x 32768, B 32768 x 16384
# (the miniapps' default of m/2 right-hand sides), hegst at n = 32768, herk
# at n = k = 16384; every trsm/trmm case at (m, n) = BLAS_SWEEP. Their gates
# (units in phase_blas_main's line): the miniapps' (500 for trsm/trmm, 1000
# for hegst), which at these orders sit near max|B| itself (500 m eps32 =
# 1.95 at m = 32768), and the smoke's own BLAS_BOUND. On an H100, sound runs
# read trsm 9.7e-5 (left) and 8.4e-4 (right), trmm 5.7e-5, the n = 2048
# sweep 0.012 at most; a skipped leaf solve reads 255, a skipped leaf
# multiply 126. hegst is held in units of n eps32 max|R64| (R is O(1/n):
# the miniapp's max(1, .) would hide a fault; a skipped leaf solve read 1.4
# in those units).
N_BLAS, NRHS_BLAS, N_HERK = 32768, 16384, 16384
BLAS_SWEEP = (2048, 1024)
BLAS_BOUND = 1.0
# the distributed BLAS-3's f32 calls are also held to TF32_GATE in the same
# units, which separates f32 products from one-pass TF32 ones (TF32 stays
# off; BLAS_BOUND does not): on an H100 the f32 calls read 4.5e-4 at most,
# and with TF32 products gemm and hemm 0.071, trmm 0.12, gen_to_std 0.22
# and trsm 0.25
TF32_GATE = 0.01
MINIAPP_BLAS_BOUND, MINIAPP_HEGST_BOUND = 500.0, 1000.0
HEGST_SLICE = 4096
# eigh_gen at eigh_main's configuration: residual in units of n eps32
# max(1, max|A|) and B-orthogonality in units of n eps32; the miniapp's
# bound is 2000 in both. An H100 reads 5.8e-4 and 0.015 sound; one column
# of B's factor scaled by 1.5 reads 12.8 and 1.65.
GEN_BOUNDS = {"res": 0.1, "borth": 0.2}
# kernel_runner's batch in stage_miniapps; the distributed BLAS-3 on grids
# of four gloo ranks: n of the 2x2 and 1x4 grids, the inputs' seed, and
# the route bound against the 1x1 grid in units of n eps32 max|want| (one
# entry moved by 1e-3 reads 1.0 or more there)
STAGE_COUNT = 64
N_GRID_LINE, GRID_BLAS_SEED, GRID_BLAS_BOUND = 4096, 7, 0.05
GRID_MINIAPP = ["-n", "4096", "-b", "512", "--grid-rows", "2", "--grid-cols", "2",
                "--comm-backend", "gloo", "--check", "--nruns", "1", "--nwarmups", "0"]
# the distributed eigensolver on four gloo ranks sharing the card: eigh_dist
# (f32, nb = 512, band 128) on 2x2 and 1x4 grids of the same ranks, each
# (grid, n, stage-2 mode) below, eigh_gen_dist on 2x2 at N_GEN_GRID, the
# inputs' seed, and the seven eigensolver miniapps' distributed branches.
# The pipelined stage 2 runs at n = 1024: each of its ~3n wavefront steps
# is up to two send/receives staged through the host between processes
# that time-slice the card (on an H100, eigh_dist at n = 1024 took 14-22 s
# a rank with it on 2x2, 9-11 s replicated at n = 4096). The replicated 2x2
# case runs at n = 2048 (it ran at 4096 before the user surfaces' phases
# joined the script's time limit).
EIG_GRID_CASES = [((2, 2), 2048, "replicated"), ((2, 2), 1024, "pipelined"),
                  ((1, 4), 2048, "replicated"), ((1, 4), 1024, "pipelined")]
N_GEN_GRID, EIG_GRID_SEED = 2048, 41
# the checker's planted divergences on the 2x2 ranks (expected finding, the
# most seconds it may take to come back)
PLANT_FINDINGS = {"extra_allreduce": "while-collective", "skipped_bcast": "cond-divergent",
                  "p2p_epoch": "p2p-unpaired"}
PLANT_SECONDS = 10.0
# the planted stall (tests/torch_debug_ranks.py's timings): rank 0 reaches
# a sum over the grid STALL_S late against a checker timeout of
# STALL_TIMEOUT; ranks 1, 2 and 3 each report their wait
STALL_TIMEOUT, STALL_S = 2.0, 3.0
# the grid's gates, in eigh's units (orth in n eps32; res, eig in n eps32
# max|A|): the distributed merge of the D&C keeps orthogonality less well
# than the local one, in JAX's as in the port's (on an H100 the replicated
# 2x2 n = 4096 and 1x4 n = 2048 runs read orth 4.6 and 5.9), so these are
# wider than EIGH_BOUNDS, as is eig, whose
# n eps32 unit shrinks with n (a sound 1x4 n = 1024 run read 12.1); the
# eigenvalues are also held to the 1x1 grid's within 1 n eps32 max|w|
GRID_EIGH_BOUNDS = {"orth": 50.0, "res": 20.0, "eig": 50.0}
GRID_GEN_BOUNDS = {"res": 20.0, "borth": 50.0}
EIG_GRID_COMMON = ["--grid-rows", "2", "--grid-cols", "2", "--comm-backend", "gloo", "--check",
                   "--nruns", "1", "--nwarmups", "0"]
EIG_GRID_MINIAPPS = [
    ("eigensolver", miniapp_eigensolver, ["-n", "512", "-b", "128"]),
    ("gen_eigensolver", miniapp_gen_eigensolver, ["-n", "512", "-b", "128"]),
    ("reduction_to_band", miniapp_reduction_to_band, ["-n", "512", "--band-size", "128"]),
    ("band_to_tridiag", miniapp_band_to_tridiag, ["-n", "512", "--band-size", "128"]),
    ("tridiag_solver", miniapp_tridiag_solver, ["-n", "512"]),
    ("bt_band_to_tridiag", miniapp_bt_band_to_tridiag, ["-n", "512", "--band-size", "128"]),
    ("bt_reduction_to_band", miniapp_bt_reduction_to_band, ["-n", "512", "--band-size", "128"])]

# the user surfaces: dlaf_pspotrf's turns against cholesky (both are warm:
# cholesky ran in an earlier phase), the
# tile-aligned sub-matrix call (n = 8192 at ia = ja = 513 of a 16384
# matrix), and the four gloo ranks' DistMatrix surfaces (n), inputs' seed
# and sub-matrix tile offset; SURFACE_TIMES keeps the Python surface's
# seconds for the C caller's
SURFACE_TURNS = ("surface", "direct")
N_SUB, N_SUB_FULL = 8192, 16384
N_SURF_GRID, GRID_SURF_SEED, SUB_OFFSET = 8192, 61, (1, 2)
SURFACE_TIMES = {}
SURFACES_HERE = {}     # the surfaces' checks that phase_c_api runs in this process
SURFACES_FOUR = []     # and those phase_dist_eigh_grid's ranks run, rank by rank
# eigh_dist's and eigh_gen_dist's seconds on the eigen entries' inputs,
# from phase_dist_eigh_main (the same function on the same input in this
# process), so that the ScaLAPACK phase runs each eigensolver surface
# without running that function again
DIRECT_TIMES = {}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` on the card, by CUDA events, after one warm-up."""
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def phase_device() -> None:
    t0 = time.perf_counter()
    log = _build.build_all()
    emit("device", kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi_line(), torch=torch.__version__, cuda=torch.version.cuda,
         build_seconds=round(time.perf_counter() - t0, 3), build=log)


def _spd_tile(g, nb, dtype, upper):
    """SPD tile with large garbage in the triangle the factor must not read."""
    a = gen.random_hermitian_positive_definite(g, nb, torch.float32)
    junk = 1e3 * gen.random_general(g, (nb, nb), torch.float32)
    ones = torch.ones_like(a, dtype=torch.bool)
    return torch.where(ones.triu() if upper else ones.tril(), a, junk).to(dtype)


def _planted(a, upper, skip):
    """A planted fault: the f64 factor of ``a`` (its ``upper`` or lower
    triangle) by 32-row slabs, as K1 computes it, with slab ``skip``'s
    rank-32 trailing update left out; rounded to a's dtype."""
    w = symmetrize_tri(a.double(), lower=not upper)
    u = torch.zeros_like(w)
    for s, k0 in enumerate(range(0, w.shape[0], 32)):
        k1 = k0 + 32
        ukk = torch.linalg.cholesky(w[k0:k1, k0:k1]).mT
        u[k0:k1, k0:k1] = ukk
        u[k0:k1, k1:] = torch.linalg.solve_triangular(ukk.mT, w[k0:k1, k1:], upper=False)
        if s != skip:
            w[k1:, k1:] -= u[k0:k1, k1:].mT @ u[k0:k1, k1:]
    u = u.to(a.dtype)
    return u if upper else u.mT.contiguous()


def _k1_case(a, nb, upper, dtype, view):
    """K1 on ``a`` against its plain version, and the same check against a
    planted fault (the last slab update but one skipped), which it must
    reject."""
    bf16 = dtype == torch.bfloat16
    got = potrf_tile(a, upper=upper)
    # bf16: the f32 factor of the same bf16 input, which K1 rounds once
    want = potrf_tile_ref(a.float() if bf16 else a, upper=upper)
    dev = factor_deviation(got, want, K1_C, bf16=bf16)
    planted = factor_deviation(_planted(a, upper, nb // 32 - 2), want, K1_C, bf16=bf16)
    err = float((got.float() - want).abs().max())
    other = torch.tril(got, -1) if upper else torch.triu(got, 1)
    what = f"K1 nb={nb} upper={upper} {dtype} view={view}"
    require(bool(torch.isfinite(got).all()), f"{what}: finite")
    require(dev <= 1.0, f"{what}: deviation {dev} > 1")
    require(planted > 1.0, f"{what}: the check passes a planted fault ({planted})")
    require(float(other.abs().max()) == 0.0, f"{what}: other triangle zero")
    key = str(dtype).replace("torch.", "")
    emit("k1", nb=nb, upper=upper, dtype=key, lda=a.stride(0), max_abs_err=err,
         deviation=dev, planted_fault_deviation=planted, bound=1.0,
         plan=potrf_tile_plan(nb, bf16))
    return key, err, dev


def phase_k1() -> None:
    """K1 against its plain version: nb 64..NB_MAX, upper and lower, f32 and
    bf16, and nb = 512 views with the main path's leading dimension; each
    case's launch plan (cluster blocks, shared memory a block, whether the
    working tile is resident in the cluster)."""
    g = torch.Generator(device=DEV).manual_seed(1)
    worst = {}
    cases = [(_spd_tile(g, nb, dtype, upper), nb, upper, dtype, False)
             for nb in K1_NBS for upper in (True, False)
             for dtype in (torch.float32, torch.bfloat16)]
    bufs = []
    for upper in (True, False):
        # the leaf as potrf_upper/potrf_lower pass it: a view into the
        # (n, n) buffer, leading dimension n = 32768; the kernel must not
        # write into it
        nb = NB_MAIN
        buf = 1e3 * gen.random_general(g, (2 * nb, N_MAIN), torch.float32)
        j0 = N_MAIN // 4
        view = buf[nb:, j0:j0 + nb]
        view.copy_(_spd_tile(g, nb, torch.float32, upper))
        bufs.append((buf, buf.clone()))
        cases.append((view, nb, upper, torch.float32, True))
    for a, nb, upper, dtype, view in cases:
        key, err, dev = _k1_case(a, nb, upper, dtype, view)
        worst[key] = max(worst.get(key, (0.0, 0.0)), (dev, err))
    require(all(torch.equal(b, b0) for b, b0 in bufs), "K1 left its input view unchanged")
    del cases, bufs
    # a non-positive pivot gives NaN from there on, no trap
    nb, piv = 256, 100
    a = gen.random_hermitian_positive_definite(g, nb, torch.float32)
    a[piv, piv] = -1.0
    d = potrf_tile(a, upper=True).diagonal()
    torch.cuda.synchronize()
    require(bool(torch.isfinite(d[:piv]).all()) and bool(torch.isnan(d[piv:]).all()),
            "K1 non-SPD tile: NaN from the failing pivot on")
    a = _spd_tile(g, NB_MAIN, torch.float32, True)
    ms = cuda_ms(lambda: potrf_tile(a, upper=True), 20)
    plain_ms = cuda_ms(lambda: potrf_tile_ref(a, upper=True), 20)
    full = symmetrize_tri(a, lower=False)
    library_ms = cuda_ms(lambda: torch.linalg.cholesky_ex(full), 20)
    # nb^3/3 flops; the tile read once and the factor written once
    nb3 = NB_MAIN
    bound = {"operations": nb3**3 / 3 / PEAK_F32 * 1e3, "bytes": 2 * 4 * nb3**2 / PEAK_BYTES * 1e3}
    bound_by = max(bound, key=bound.get)
    plan = potrf_tile_plan(NB_MAIN)
    emit("k1_nonspd", nb=nb, pivot=piv, nan_from_pivot=True)
    emit("k1_time", nb=NB_MAIN, dtype="float32", upper=True, ms=ms, plain_ms=plain_ms,
         library_ms=library_ms, bound_ms=bound[bound_by], bound_by=bound_by,
         serial_column_steps=nb3, slab_steps=nb3 // 32, cluster_blocks=plan["cluster_blocks"],
         smem_bytes_per_block=plan["smem_bytes"], resident=bool(plan["resident"]),
         clusters_fit=plan["clusters"])
    KERNELS["potrf_tile"] = dict(
        name="potrf_tile", route="cuda", source="dlaf_tpu_torch/csrc/potrf_tile.cu",
        replaces="dlaf_tpu/ops/pallas/potrf.py:130", max_abs_err=worst["float32"][1],
        deviation=worst["float32"][0], max_abs_err_bf16=worst["bfloat16"][1],
        deviation_bf16=worst["bfloat16"][0], bound=K1_BOUND, ms=ms, plain_ms=plain_ms,
        bound_ms=bound[bound_by], bound_by=bound_by, library_ms=library_ms,
        timed_shape=[NB_MAIN, NB_MAIN], cluster_blocks=plan["cluster_blocks"],
        smem_bytes_per_block=plan["smem_bytes"])


def _strided(g, rows, cols, pad):
    """(rows, cols) f32 view with leading dimension cols + pad and an offset."""
    buf = gen.random_general(g, (rows, cols + pad), torch.float32)
    return buf[:, pad:] if pad else buf


def phase_k2() -> None:
    """K2 against its plain version computed in f64: main-path shapes, both
    layouts, and ragged shapes of row-strided views that are not 16-byte
    aligned (K2's 4-byte copy path); each case beside two planted faults,
    K2's split cut to one TF32 term and to two (emulated on the card), which
    the bound must reject."""
    g = torch.Generator(device=DEV).manual_seed(2)
    worst = (0.0, 0.0)
    for m, n, k, kmaj, pad in K2_CASES:
        c = _strided(g, m, n, pad)
        x = _strided(g, k, m, pad) if kmaj else _strided(g, m, k, pad)
        y = _strided(g, k, n, pad)
        want = ksub_matmul_ref(c.double(), x.double(), y.double(), kmaj)
        out = _strided(g, m, n, pad)
        out.copy_(c)
        plan = ksub_matmul_plan(out, x, y, kmaj)
        got = ksub_matmul(out, x, y, x_k_major=kmaj)
        plain = ksub_matmul_ref(c, x, y, kmaj)
        # one f32 accumulator per output walks all k terms: its rounding
        # error grows like eps k max|x| max|y| (measured: 0.8 of that at
        # k = 16384); one or two TF32 terms land far above 2x that
        bound = EPS32 * (2 * k * float(x.abs().max()) * float(y.abs().max())
                         + float(c.abs().max()))
        err = float((got.double() - want).abs().max())
        plain_err = float((plain.double() - want).abs().max())
        planted = {f"planted_{t}_term_err": float(
            (ksub_matmul_split_ref(c, x, y, kmaj, terms=t).double() - want).abs().max())
            for t in (1, 2)}
        require(err <= bound, f"K2 {(m, n, k, kmaj)}: {err} > {bound}")
        require(min(planted.values()) > bound,
                f"K2 {(m, n, k, kmaj)}: the bound passes a planted fault ({planted})")
        worst = max(worst, (err, bound))
        extra = {}
        if (m, n, k) == K2_TIMED:
            torch.backends.cuda.matmul.allow_tf32 = True
            tf32 = ksub_matmul_ref(c, x, y, kmaj)
            torch.backends.cuda.matmul.allow_tf32 = False
            extra["tf32_err"] = float((tf32.double() - want).abs().max())
            del tf32
        emit("k2", m=m, n=n, k=k, x_k_major=kmaj, ld_pad=pad, max_abs_err=err,
             plain_f32_err=plain_err, bound=bound, plan=plan, **planted, **extra)
        del c, x, y, want, out, got, plain
    for m, n, k in K2_TIMES:
        c, x, y = (gen.random_general(g, s, torch.float32) for s in ((m, n), (k, m), (k, n)))
        reps = 5 if m * n * k > 2**36 else 50
        ms = cuda_ms(lambda: ksub_matmul(c, x, y), reps)
        plain_ms = cuda_ms(lambda: ksub_matmul_ref(c, x, y), reps)
        library_ms = cuda_ms(lambda: torch.addmm(c, x.T, y, alpha=-1), reps)
        # the operations K2 runs: three TF32 passes, 6mnk on the tensor
        # cores; C read and written once, X and Y read once. The f32 FFMA
        # bound of the same 2mnk product (K6's route) is kept beside it.
        bound = {"operations": 6 * m * n * k / PEAK_TF32 * 1e3,
                 "bytes": 4 * (2 * m * n + k * m + k * n) / PEAK_BYTES * 1e3}
        bound_by = max(bound, key=bound.get)
        ffma_ms = max(2 * m * n * k / PEAK_F32 * 1e3, bound["bytes"])
        tflops = 2 * m * n * k / ms / 1e9
        emit("k2_time", m=m, n=n, k=k, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
             bound_ms=bound[bound_by], bound_by=bound_by, bound_tf32x3_ms=bound[bound_by],
             bound_f32_ffma_ms=ffma_ms, tflops=tflops, of_f32_peak=tflops * 1e12 / PEAK_F32,
             tensor_tflops=3 * tflops, of_tf32_peak=3 * tflops * 1e12 / PEAK_TF32,
             plain_tflops=2 * m * n * k / plain_ms / 1e9,
             library_tflops=2 * m * n * k / library_ms / 1e9, plan=ksub_matmul_plan(c, x, y))
        if (m, n, k) == K2_TIMED:
            KERNELS["ksub_matmul"] = dict(
                name="ksub_matmul", route="cuda", source="dlaf_tpu_torch/csrc/ksub_tf32x3.cu",
                replaces="dlaf_tpu/ops/pallas/trailing.py:109", max_abs_err=worst[0],
                bound=worst[1], ms=ms, plain_ms=plain_ms, bound_ms=bound[bound_by],
                bound_by=bound_by, bound_tf32x3_ms=bound[bound_by], bound_f32_ffma_ms=ffma_ms,
                library_ms=library_ms,
                timed_shape=[m, n, k])
        del c, x, y


def _wide(dtype):
    return torch.complex128 if dtype.is_complex else torch.float64


def _k3_band(g, n, b, dtype):
    """Strip storage of a random hermitian band matrix of bandwidth b, the
    band in f64 (complex128) with both triangles, and max|A|."""
    a = torch.triu(gen.random_hermitian(g, n, dtype), -b)   # lower band (+ unread upper)
    low = torch.tril(a).to(_wide(dtype))
    return bs.band_to_strips(a, b), low + torch.tril(low, -1).mH, float(low.abs().max())


def _eigh_input(dtype) -> torch.Tensor:
    """The matrix eigh_main (f32) or eigh_c64 (complex64) solves."""
    n = N_EIGH if dtype == torch.float32 else N_EIGH_C
    return gen.random_hermitian(torch.Generator(device=DEV).manual_seed(EIGH_SEED[dtype]), n, dtype)


def _k3_main_band(dtype):
    """K3's input on the main path: the band stage 1 makes of eigh's
    matrix, as strips, in f64 (complex128), and its max|A|."""
    packed, _ = reduction_to_band(_eigh_input(dtype), B_EIGH)
    band = extract_band(packed, B_EIGH)
    del packed
    return bs.band_to_strips(band, B_EIGH), band.to(_wide(dtype)), float(band.abs().max())


def _k3_plain(strips, band, n, b):
    """K3's plain version on ``strips``, or on the same ``band`` densely
    where n > K3_SEQ_MAX (see K3_SEQ_MAX)."""
    if n <= K3_SEQ_MAX:
        return band_to_tridiag_strips_ref(strips, n, b)
    return band_to_tridiag_pipelined(band, b)


@contextlib.contextmanager
def _planted_reflector(step: int):
    """band_to_tridiag_pipelined with lane 0's reflector at wavefront step
    ``step`` given tau = 0: that chase cleans its column but skips its
    update, a planted fault."""
    calls = [0]

    def hh(x):
        v, tau, beta = householder_vector(x)
        if calls[0] == step:
            tau = tau.clone()
            tau[0] = 0
        calls[0] += 1
        return v, tau, beta

    b2t.householder_vector = hh
    try:
        yield
    finally:
        b2t.householder_vector = householder_vector


_K3_POOL = None   # phase_k3's worker processes for the plain references


def _np(t):
    return None if t is None else t.cpu().numpy()


def _k3_reference(kind, strips, band, n, b, arg=None):
    """One K3 plain reference, computed on the card by a worker process of
    phase_k3: "plain" (``_k3_plain``), "planted_pipelined" (the pipelined
    chase with lane 0's reflector at wavefront step ``arg`` lost) or
    "planted_strips" (the plain chase with chase ``arg`` skipped). The
    references are host-bound loops of small launches, and one process
    drives one such loop at a time. Inputs and outputs cross the process
    boundary as numpy arrays (pickled through the pipe)."""
    strips = None if strips is None else torch.from_numpy(strips).to(DEV)
    band = None if band is None else torch.from_numpy(band).to(DEV)
    if kind == "plain":
        out = _k3_plain(strips, band, n, b)
    elif kind == "planted_pipelined":
        with _planted_reflector(arg):
            out = band_to_tridiag_pipelined(band, b)
    else:
        out = _planted_chase(strips, n, b, arg)
    return tuple(_np(x) for x in out)


def _k3_de_distance(got, want) -> float:
    """max |got - want| over d and |e| (invariant under the sign choices)."""
    return max(float((got[0].to(want[0].dtype) - want[0]).abs().max()),
               float((got[1].abs().to(want[1].real.dtype) - want[1].abs()).abs().max()))


def _k3_t(got):
    d, e = got[0].double(), got[1]
    e = e.to(torch.complex128) if e.is_complex() else e.double()
    return torch.diag(d).to(e.dtype) + torch.diag(e, -1) + torch.diag(e.conj(), 1)


def _k3_eig(got, ew) -> float:
    """max|eig(T) - ew| in f64, ew the band's eigenvalues, in units of
    eps32 ||B||_2."""
    return float((torch.linalg.eigvalsh(_k3_t(got)) - ew).abs().max()) / (EPS32 * float(ew.abs().max()))


def _k3_res(got, band64, n, b, bnorm) -> float:
    """max|B Q - Q T| with Q = the product of the record's reflectors, in
    f64, in units of eps32 ||B||_2. Q is applied by the sweepwise oracle up
    to n = K3_SEQ_MAX and by stage 4's grouped WY apply beyond."""
    wide = band64.dtype
    eye = torch.eye(n, dtype=wide, device=DEV)
    vs, taus = got[2].to(wide), got[3].to(wide)
    q = bt_band_to_tridiag_sweepwise(eye, vs, taus, b) if n <= K3_SEQ_MAX \
        else bt_band_to_tridiag(eye, vs, taus, b)
    del eye
    return float((band64 @ q - q @ _k3_t(got).to(wide)).abs().max()) / (EPS32 * bnorm)


def _planted_chase(strips, n, b, skip):
    """The plain chase (band_to_tridiag_strips_ref) with the update of
    chase ``skip`` = (s, c) left out: a planted fault."""
    strips = strips.clone()
    ncmax = -(-(n - 1) // b)
    vs = strips.new_zeros((n - 2, ncmax, b))
    taus = strips.new_zeros((n - 2, ncmax))
    for s in range(n - 2):
        for c in range(-(-(n - 1 - s) // b)):
            i0 = s + 1 + c * b
            g_, s3, im = bs._chase_window(strips, i0, b)
            g_new, v, tau = bs.chase_math(g_, c == 0, b)
            if (s, c) != skip:
                bs._chase_scatter(strips, g_new, s3, im, i0, b)
            vs[s, c], taus[s, c] = v, tau
    d, e = bs.strips_extract_tridiag(strips, n, b)
    return d, e, vs, taus


def _k3_bound_ms(n, b, dtype) -> tuple[float, str, dict]:
    """The least time of one K3 call at (n, b): the larger of its flops over
    the f32 peak and its bytes (strips read and written once, the record
    written once) over HBM bandwidth. A chase does ~12 b^2 real flops (two
    reductions and two rank-1 updates over CY and B, one symmetric pass and
    update of S's lower triangle); complex arithmetic four times that."""
    chases = sum(-(-(n - 1 - s) // b) for s in range(n - 2))
    cplx = dtype.is_complex
    flops = 12.0 * b * b * chases * (4 if cplx else 1)
    elem = 8 if cplx else 4
    ncmax = -(-(n - 1) // b)
    nbytes = elem * (2 * bs.n_strips(n, b) * b * bs.STRIP_W * b + (n - 1) * ncmax * (b + 1))
    ms = {"operations": flops / PEAK_F32 * 1e3, "bytes": nbytes / PEAK_BYTES * 1e3}
    by = max(ms, key=ms.get)
    return ms[by], by, {"chases": chases, "flops": flops, "bytes": nbytes,
                        "wavefront_steps": wavefront_steps(n)}


def _k3_case(what, strips, band64, n, b, amax, plant=None) -> dict:
    """K3 on ``strips`` against its plain version (the checks described above K3_REL)
    and a bit-identical repeat. ``plant``, where given, is the
    ``_k3_reference`` arguments of a planted fault (d, e, vs, taus) that
    the eig check must reject; the res check is shown K3's own record with
    one tau lost. The plain version in f64 and the planted fault run in
    phase_k3's two worker processes while this one runs the plain version
    in f32 (timed: ``plain_ms``). Emits its readings before it checks
    them."""
    t0 = time.perf_counter()
    parts, last = {}, [t0]

    def lap(name):   # host seconds of each part of the case, for the budget
        torch.cuda.synchronize()
        now = time.perf_counter()
        parts[name] = parts.get(name, 0.0) + now - last[0]
        last[0] = now

    dtype = strips.dtype
    plan = chase_plan(n, b, dtype)
    got = band_to_tridiag_strips_kernel(strips, n, b)
    lap("kernel")
    fut64 = _K3_POOL.submit(_k3_reference, "plain", _np(strips.to(band64.dtype)), _np(band64), n, b)
    fut_bad = None
    if plant is not None:
        kind, pstrips, pband, *rest = plant
        fut_bad = _K3_POOL.submit(_k3_reference, kind, _np(pstrips), _np(pband), *rest)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = _k3_plain(strips, band64.to(dtype), n, b)
    stop.record()
    lap("plain")
    want64 = tuple(torch.from_numpy(x).to(DEV) for x in fut64.result())
    bad = tuple(torch.from_numpy(x).to(DEV) for x in fut_bad.result()) if fut_bad is not None else None
    lap("wait_workers")
    ew = torch.linalg.eigvalsh(band64)
    lap("eigvalsh_band")
    bnorm = float(ew.abs().max())
    floor = n * EPS32 * max(1.0, amax)
    inherent = _k3_de_distance(want, want64)
    denom = min(max(inherent, floor), K3_REL_CAP * floor)
    r = {"plain": "strips" if n <= K3_SEQ_MAX else "pipelined", "amax": amax, "norm2": bnorm,
         "plain_ms": start.elapsed_time(stop), "max_abs_err_de": _k3_de_distance(got, want),
         "plain_f32_vs_f64": inherent, "plain_f32_vs_f64_floors": inherent / floor}
    r["rel"] = _k3_de_distance(got, want64) / denom
    r["eig"], r["eig_plain"] = _k3_eig(got, ew), _k3_eig(want, ew)
    lap("eig")
    r["res"], r["res_plain"] = _k3_res(got, band64, n, b, bnorm), _k3_res(want, band64, n, b, bnorm)
    lap("res")
    r["eig_bound"], r["res_bound"] = K3_EIG * max(1.0, r["eig_plain"]), K3_RES * max(1.0, r["res_plain"])
    r["finite"] = all(bool(torch.isfinite(x).all()) for x in got)
    again = band_to_tridiag_strips_kernel(strips, n, b)
    r["bit_identical"] = all(torch.equal(x, y) for x, y in zip(got, again))
    del again
    lap("repeat")
    if plant is not None:
        r["planted_fault_rel"] = _k3_de_distance(bad, want64) / denom
        r["planted_fault_eig"] = _k3_eig(bad, ew)
        del bad
        lap("eig")
        taus = got[3].clone()
        taus[n // 2, 1] = 0                        # one recorded reflector lost
        r["planted_fault_res"] = _k3_res((*got[:3], taus), band64, n, b, bnorm)
        lap("res")
    r["seconds"] = time.perf_counter() - t0
    r["part_seconds"] = parts
    emit("k3", n=n, b=b, dtype=str(dtype).replace("torch.", ""), **plan._asdict(),
         bounds={"rel": K3_REL, "rel_cap": K3_REL_CAP}, **r)
    # the wrapper's mirror of the launcher's rule (dtype, b) -> instance
    mirror = chase_instance(b, dtype, device_smem_optin(DEV))
    require(plan.instance == mirror and
            (plan.instance == "streamed" or plan.smem_bytes == resident_smem_bytes(b, dtype)),
            f"{what}: the launcher's {plan} against chase_instance "
            f"{mirror}, {resident_smem_bytes(b, dtype)} bytes resident")
    require(r["finite"], f"{what}: finite")
    for k, bound in (("rel", K3_REL), ("eig", r["eig_bound"]), ("res", r["res_bound"])):
        require(r[k] <= bound, f"{what}: {k} {r[k]} > {bound}")
    require(r["bit_identical"], f"{what}: two runs bit-identical")
    if plant is not None:
        require(r["planted_fault_eig"] > r["eig_bound"] and r["planted_fault_res"] > r["res_bound"],
                f"{what}: the checks pass a planted fault ({r})")
    return r


def phase_k3() -> None:
    """K3 against its plain version on the card, planted faults beside the
    checks, bit-identical repeats: random bands, the main path's own bands
    (K3 timed on the n = 8192 f32 one), and a band whose lanes outnumber
    the co-resident blocks. The f64 references and the planted faults run
    in two worker processes, stopped at the end."""
    global _K3_POOL
    _K3_POOL = concurrent.futures.ProcessPoolExecutor(
        2, mp_context=torch.multiprocessing.get_context("spawn"))
    try:
        _phase_k3()
    finally:
        _K3_POOL.shutdown(wait=True, cancel_futures=True)
        _K3_POOL = None


def _phase_k3() -> None:
    g = torch.Generator(device=DEV).manual_seed(7)
    worst = {"err": 0.0, "rel": 0.0, "eig": 0.0, "res": 0.0}
    plain_ms = None

    def keep(r):
        worst["err"] = max(worst["err"], r["max_abs_err_de"])
        for k in ("rel", "eig", "res"):
            worst[k] = max(worst[k], r[k])

    for n, b, dtype, lo, chunk in K3_CASES:
        strips, band64, amax = _k3_band(g, n, b, dtype)
        what = f"K3 n={n} b={b} {dtype} sweep_lo={lo} chunk={chunk}"
        if chunk is not None:
            # the chunked record is rows [lo, lo + chunk) of the full one;
            # rows past the last sweep (n - 2) are zero, no-ops of tau = 0
            got = band_to_tridiag_strips_kernel(strips, n, b, lo, chunk)
            ref = band_to_tridiag_strips_kernel(strips, n, b)
            k = max(0, min(chunk, n - 2 - lo))
            same = torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]) and \
                torch.equal(got[2][:k], ref[2][lo:lo + k]) and \
                torch.equal(got[3][:k], ref[3][lo:lo + k])
            past = not got[2][k:].any() and not got[3][k:].any()
            require(same and past, f"{what}: rows of the full record ({same}), zero past the "
                    f"last sweep ({past})")
            emit("k3_chunk", n=n, b=b, dtype=str(dtype).replace("torch.", ""), sweep_lo=lo,
                 sweep_chunk=chunk, equal_to_full_record_rows=same, sweeps_past_end=chunk - k,
                 zero_past_end=past)
            continue
        plant = None
        if (n, b, dtype) == (*K3_PLANTED, torch.float32):
            plant = ("planted_strips", strips, None, n, b, (n // 2, 1))
        r = _k3_case(what, strips, band64, n, b, amax, plant)
        if (n, b, dtype) == (*K3_PLAIN_TIMED, torch.float32):
            plain_ms = r["plain_ms"]
        keep(r)
        del strips, band64
    # the main path's own inputs; the planted fault at n = 8192 skips the
    # update of chase (n/2, 0), in the pipelined chase's step 4 (n/2)
    b = B_EIGH
    for n, dtype in K3_MAIN:
        t0 = time.perf_counter()
        strips, band64, amax = _k3_main_band(dtype)
        emit("k3_main_band", n=n, b=b, dtype=str(dtype).replace("torch.", ""),
             seconds=time.perf_counter() - t0)
        plant = None
        if dtype == torch.float32:
            plant = ("planted_pipelined", None, band64.to(dtype), n, b, 4 * (n // 2))
            ms = cuda_ms(lambda: band_to_tridiag_strips_kernel(strips, n, b), 3)
        r = _k3_case(f"K3 main-path band n={n} b={b} {dtype}", strips, band64, n, b, amax, plant)
        if dtype == torch.float32:
            pipelined_ms = r["plain_ms"]
        keep(r)
        del strips, band64
    # a narrow band whose lanes outnumber the co-resident blocks: n such that
    # lanes = 1.5 x the grid, so half the blocks take two lanes a step
    b = K3_MULTI_B
    blocks = chase_plan(1 << 20, b, torch.float32).blocks
    n = 3 * b * (blocks + blocks // 2) + 2
    lanes, grid, *_ = chase_plan(n, b, torch.float32)
    require(lanes > grid, f"K3 n={n} b={b}: {lanes} lanes fit {grid} blocks")
    strips, band64, amax = _k3_band(g, n, b, torch.float32)
    r = _k3_case(f"K3 n={n} b={b} lanes={lanes} blocks={grid}", strips, band64, n, b, amax)
    emit("k3_lanes", n=n, b=b, lanes=lanes, blocks=grid)
    keep(r)
    del strips, band64
    n, b = N_EIGH, B_EIGH
    bound_ms, bound_by, work = _k3_bound_ms(n, b, torch.float32)
    plan = chase_plan(n, b, torch.float32)
    require(plan.instance == "resident", f"K3 n={n} b={b} f32 (the main path's) takes {plan}")
    us_per_step = ms * 1e3 / wavefront_steps(n)
    emit("k3_time", n=n, b=b, dtype="float32", ms=ms, us_per_step=us_per_step,
         lanes=plan.lanes, blocks=plan.blocks, instance=plan.instance, plain_ms=plain_ms,
         plain_shape=list(K3_PLAIN_TIMED), plain_pipelined_ms=pipelined_ms,
         bound_ms=bound_ms, bound_by=bound_by, **work)
    KERNELS["band_to_tridiag_strips"] = dict(
        name="band_to_tridiag_strips", route="cuda", source="dlaf_tpu_torch/csrc/band2tridiag.cu",
        replaces="dlaf_tpu/ops/pallas/band2tridiag.py:426", max_abs_err=worst["err"],
        rel=worst["rel"], eig=worst["eig"], res=worst["res"],
        bound=f"rel <= {K3_REL}; eig, res <= {K3_EIG}, {K3_RES} x max(1, the plain "
              "version's), in eps32 ||B||_2",
        ms=ms, us_per_step=us_per_step, instance=plan.instance, plain_ms=plain_ms,
        plain_shape=list(K3_PLAIN_TIMED), plain_pipelined_ms=pipelined_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None, timed_shape=[n, b])


def _eigh_stages(a, b: int):
    """dlaf_tpu_torch.eigh's five stages (n % b == 0), as driver.eigh runs
    them, with a synchronization after each: (w, v, seconds per stage,
    the stage outputs the planted faults start from). A copy of the
    driver's pipeline: phase_eigh_main holds its w bit-equal to dt.eigh's."""
    tune = dt.get_tune_parameters()
    secs, out = {}, {}

    def lap(name, t0):
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return time.perf_counter()

    torch.cuda.synchronize()
    t = time.perf_counter()
    out["packed"], out["taus1"] = reduction_to_band(a, b)
    t = lap("stage1_red2band", t)
    d, e, out["vs"], out["taus2"] = band_to_tridiag_auto(extract_band(out["packed"], b), b)
    t = lap("stage2_band2tridiag", t)
    out["d"], (out["e"], out["phases"]) = d, _phase_normalize(e, a.dtype)
    w, out["q3"] = tridiag_eigh(d, out["e"], tune.laed4_max_iter)
    t = lap("stage3_tridiag_dc", t)
    v = _stage4(out, b, out["taus2"])
    t = lap("stage4_bt_band_to_tridiag", t)
    v = bt_reduction_to_band(v, out["packed"], out["taus1"], b)
    lap("stage5_bt_reduction_to_band", t)
    return w, v, secs, out


def _stage4(out, b, taus2):
    q = out["phases"][:, None] * out["q3"].to(out["packed"].dtype)
    return bt_band_to_tridiag(q, out["vs"], taus2, b,
                              group_size=dt.get_tune_parameters().bt_band_to_tridiag_hh_apply_group_size)


def _eigh_readings(a64, w, v, w64) -> dict:
    """orth in units of n eps32, residual and eigenvalue error in units of
    n eps32 max|A|, computed in f64 (complex128) on the card; plus the
    miniapp's own gate on the same (w, v)."""
    n = a64.shape[0]
    amax = float(a64.abs().max())
    v64 = v.to(a64.dtype)
    orth = float((v64.mH @ v64 - torch.eye(n, dtype=a64.dtype, device=DEV)).abs().max())
    res = float((a64 @ v64 - v64 * w.double().to(a64.dtype)[None, :]).abs().max())
    eig = float((w.double() - w64).abs().max())
    unit = n * EPS32
    return {"orth": orth / unit, "res": res / (unit * amax), "eig": eig / (unit * amax),
            "orth_abs": orth, "res_abs": res, "eig_abs": eig,
            "miniapp_gate": orth <= 500 * unit and res <= 1000 * unit * max(amax, 1.0)}


def _eigh_gates(r: dict, what: str) -> None:
    require(r["miniapp_gate"], f"{what}: the miniapp's gates ({r})")
    for k, bound in EIGH_BOUNDS.items():
        require(r[k] <= bound, f"{what}: {k} {r[k]} > {bound}")


def phase_eigh_main() -> None:
    """The eigensolver slice at full size: eigh at n = 8192 f32, band 128.
    One warm-up, two timed runs through the entry point, one staged run
    timed by stage, the gates and the planted faults they must reject."""
    n, b = N_EIGH, B_EIGH
    a = _eigh_input(torch.float32)
    a64 = a.double()
    w64 = torch.linalg.eigvalsh(a64)
    dt.eigh(a, band=b)
    band_to_tridiag_strips_kernel.launches = 0
    secs, ws_timed = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w, v = dt.eigh(a, band=b)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        ws_timed.append(w)
    launches = band_to_tridiag_strips_kernel.launches
    require(launches > 0, "eigh at n = 8192 f32 launched K3")
    KERNELS["band_to_tridiag_strips"]["launches"] = launches
    readings = _eigh_readings(a64, w, v, w64)
    _eigh_gates(readings, "eigh n=8192 f32")
    # the staged run must be the entry point's computation: the stage table
    # describes dt.eigh only while its eigenvalues equal the timed runs' bit
    # for bit
    ws, vs_, stages, out = _eigh_stages(a, b)
    same = {"w_timed_runs": torch.equal(*ws_timed), "w_staged": torch.equal(ws, w),
            "v_staged": torch.equal(vs_, v)}
    require(same["w_staged"], f"the staged eigh computes what dt.eigh computes ({same})")
    staged = _eigh_readings(a64, ws, vs_, w64)
    _eigh_gates(staged, "staged eigh n=8192 f32")
    del vs_, w, v, ws_timed
    # planted faults: each reading must exceed its bound
    planted = {}
    bad = out["taus2"].clone()
    bad[n // 2, 0] = 0                            # one stage-2 reflector dropped
    v_bad = bt_reduction_to_band(_stage4(out, b, bad), out["packed"], out["taus1"], b)
    planted["res"] = _eigh_readings(a64, ws, v_bad, w64)["res"]
    bad = out["taus1"].clone()
    bad[n // 2] *= 1.1                            # one stage-1 reflector not unitary
    v_bad = bt_reduction_to_band(_stage4(out, b, out["taus2"]), out["packed"], bad, b)
    planted["orth"] = _eigh_readings(a64, ws, v_bad, w64)["orth"]
    del v_bad
    e_bad = out["e"].clone()
    e_bad[n // 2] = 0                             # one subdiagonal entry lost
    w_bad, _ = tridiag_eigh(out["d"], e_bad, dt.get_tune_parameters().laed4_max_iter)
    planted["eig"] = float((w_bad.double() - w64).abs().max()) / (n * EPS32 * float(a64.abs().max()))
    for k, bound in EIGH_BOUNDS.items():
        require(planted[k] > bound, f"the eigh {k} check passes a planted fault ({planted[k]})")
    del out, ws, w_bad, e_bad
    torch.linalg.eigh(a)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.linalg.eigh(a)
    torch.cuda.synchronize()
    lib_s = time.perf_counter() - t0
    emit("eigh_main", n=n, band=b, dtype="float32", seconds=secs, stage_seconds=stages,
         k3_launches=launches, readings=readings, staged_readings=staged,
         bit_equal=same, bounds=EIGH_BOUNDS, planted_fault_readings=planted,
         library_ms=lib_s * 1e3, library="torch.linalg.eigh (cuSOLVER), f32")


def phase_eigh_c64() -> None:
    n = N_EIGH_C
    a = _eigh_input(torch.complex64)
    a64 = a.to(torch.complex128)
    w64 = torch.linalg.eigvalsh(a64)
    dt.eigh(a, band=B_EIGH)
    band_to_tridiag_strips_kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w, v = dt.eigh(a, band=B_EIGH)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = band_to_tridiag_strips_kernel.launches
    require(launches > 0, "eigh at n = 4096 c64 launched K3")
    readings = _eigh_readings(a64, w, v, w64)
    _eigh_gates(readings, "eigh n=4096 c64")
    emit("eigh_c64", n=n, band=B_EIGH, dtype="complex64", seconds=secs, k3_launches=launches,
         readings=readings, bounds=EIGH_BOUNDS)


def phase_miniapp_eigensolver() -> None:
    runs = {}
    for typ, n in (("s", "4096"), ("d", "1024")):
        band_to_tridiag_strips_kernel.launches = 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            miniapp_eigensolver.main(["-n", n, "--type", typ, "--check", "--nruns", "1"])
        out = buf.getvalue()
        require("check: PASSED" in out, f"miniapp_eigensolver {typ} check")
        k3 = band_to_tridiag_strips_kernel.launches
        # s runs stage 2 through K3; d through the plain strip chase
        require((k3 > 0) == (typ == "s"), f"miniapp_eigensolver {typ}: K3 launches {k3}")
        runs[typ] = {"lines": out.strip().splitlines(), "k3_launches": k3}
    emit("miniapp_eigensolver", **runs)


def _wy_slabs(g, nc, b, k=None):
    """(V, V2) slabs of random exact reflectors (tau = 2 / v^T v, so each
    WY block is orthogonal and E keeps its scale through many chases),
    formed as stage 4 forms them (bt._group_vt_all): (nc, 2b, b), or
    (nc, k, 2b, b) for k groups."""
    def one():
        vs = torch.randn((b, nc, b), generator=g, device=DEV, dtype=torch.float32)
        vs[:, :, 0] = 1.0
        taus = 2.0 / (vs * vs).sum(-1)
        return btm._group_vt_all(vs, taus, 0, b, b, nc, None)
    if k is None:
        return one()
    pairs = [one() for _ in range(k)]
    return torch.stack([p[0] for p in pairs], 1), torch.stack([p[1] for p in pairs], 1)


def _k45_run(kind, ep2, v, v2, args, b):
    """The kernel and its plain version on copies of ep2: (got, want)."""
    kern, ref = (bt_apply_group, bt_apply_group_ref) if kind == "K4" else \
        (bt_apply_fused, bt_apply_fused_ref)
    got = kern(ep2.clone(), v, v2, *args, b)
    want = ref(ep2.clone(), v, v2, *args, b)
    return got, want


def _split_faults(kind, ep2, v, v2, args, b, want, scale) -> dict:
    """Planted faults: the kernel's three TF32 passes cut to one and to two
    (K4/K5's arithmetic emulated on the card), each against the plain
    version ``want``, in units of eps32 max|E|; the check must reject both."""
    split = bt_apply_group_split_ref if kind == "K4" else bt_apply_fused_split_ref
    return {f"planted_{t}_term_err_eps":
            _err_eps(split(ep2.clone(), v, v2, *args, b, terms=t), want, scale) for t in (1, 2)}


def phase_k45() -> None:
    """K4 and K5 against their plain versions on the card: the main path's
    width and band, ragged nev, base_blk > 0 with ncvalid < ncmax, K5 with
    k in {2, 8}, phantom groups (nact < k) and nact = 0; each check beside a
    planted fault (one chase's V2 scaled by 1.1) and a bit-identical
    repeat; the main path's width (nev = 32768) also beside the one- and
    two-term TF32 splits. Errors are max|got - want| / max|E| in units of
    eps32."""
    g = torch.Generator(device=DEV).manual_seed(45)
    worst = {"K4": 0.0, "K5": 0.0}
    for kind, b, nev, nblk, args, k in K45_CASES:
        if kind == "K4":
            base, ncvalid = args
            v, v2 = _wy_slabs(g, ncvalid + 2, b)          # ncvalid < ncmax
            nsteps = ncvalid
        else:
            v0p = args[2]
            nsteps = v0p + args[1] - 1 if args[1] else 0
            v, v2 = _wy_slabs(g, max(nsteps, 1) + 1, b, k)
            args = (*args, k)
        ep2 = gen.random_general(g, (nblk * b, nev), torch.float32)
        got, want = _k45_run(kind, ep2, v, v2, args, b)
        scale = float(ep2.abs().max())
        err = float((got - want).abs().max()) / (EPS32 * scale)
        moved = float((want - ep2).abs().max()) / scale
        again = _k45_run(kind, ep2, v, v2, args, b)[0]
        r = {"kind": kind, "b": b, "nev": nev, "nblk": nblk, "args": list(args),
             "err_eps": err, "moved": moved, "bit_identical": torch.equal(got, again),
             "untouched_equal": None, "bound_eps": K45_BOUND}
        # blocks outside the chases' reach are left as they were
        hi = (args[0] + args[1]) if kind == "K4" else (args[0] + nsteps)
        lo_blk = args[0]
        keep = torch.ones(nblk, dtype=torch.bool, device=DEV)
        if nsteps:
            keep[lo_blk:hi + 1] = False
        r["untouched_equal"] = torch.equal(got.view(nblk, b, nev)[keep],
                                           ep2.view(nblk, b, nev)[keep])
        if nsteps:
            bad2 = v2.clone()
            if kind == "K4":
                bad2[nsteps // 2] *= 1.1
            else:
                bad2[v0p // 2, 0] *= 1.1       # a chase of the bottom group
            bad = _k45_run(kind, ep2, v, bad2, args, b)[0]
            r["planted_fault_err_eps"] = float((bad - want).abs().max()) / (EPS32 * scale)
            del bad
        if nev == N_LARGE:
            r.update(_split_faults(kind, ep2, v, v2, args, b, want, scale))
        emit("k45", **r)
        what = f"{kind} b={b} nev={nev} args={args}"
        require(r["bit_identical"] and r["untouched_equal"], f"{what}: {r}")
        require(err <= K45_BOUND, f"{what}: err {err} > {K45_BOUND} eps32 max|E|")
        if nsteps:
            require(moved > 0.01, f"{what}: the chases changed E ({moved})")
            require(r["planted_fault_err_eps"] > K45_BOUND,
                    f"{what}: the check passes a planted fault ({r})")
        else:
            require(torch.equal(got, ep2), f"{what}: nact = 0 leaves E as it was")
        if nev == N_LARGE:
            require(min(r["planted_1_term_err_eps"], r["planted_2_term_err_eps"]) > K45_BOUND,
                    f"{what}: the check passes a one- or two-term TF32 split ({r})")
        worst[kind] = max(worst[kind], err)
        del ep2, got, want, again, v, v2
    for name, kind in (("bt_apply_group", "K4"), ("bt_apply_fused", "K5")):
        KERNELS[name] = dict(
            name=name, route="cuda", source="dlaf_tpu_torch/csrc/bt_apply.cu",
            replaces=K45_REPLACES[name], max_abs_err=worst[kind] * EPS32,
            max_err_eps_of_max_e=worst[kind], bound=f"max|got-want| <= {K45_BOUND} eps32 max|E|")


def _count_reset() -> None:
    band_to_tridiag_strips_kernel.launches = 0
    bt_apply_group.launches = bt_apply_fused.launches = 0


def _counts() -> dict:
    return {"band_to_tridiag_strips": band_to_tridiag_strips_kernel.launches,
            "bt_apply_group": bt_apply_group.launches, "bt_apply_fused": bt_apply_fused.launches}


def _large_gates(a, w, v) -> dict:
    """The probe gates of scripts/bench_sections.py heev_32768 and the
    trace gate, on the card (O(n^2) each)."""
    n = a.shape[0]
    g = torch.Generator(device=DEV).manual_seed(5)
    u = torch.randn((n, 4), generator=g, device=DEV, dtype=torch.float32)
    u /= u.norm(dim=0, keepdim=True)
    vu = v @ u
    orth = float((v.T @ vu - u).abs().max())
    res = float((a @ vu - v @ (w[:, None] * u)).abs().max())
    amax = float(a.abs().max())
    unit = n * EPS32
    return {"orth": orth / unit, "res": res / (unit * max(amax, 1.0)),
            "trace": _trace_reading(a, w), "finite": bool(torch.isfinite(v).all()),
            "ascending": bool((w[1:] >= w[:-1]).all())}


def _trace_reading(a, w) -> float:
    """|sum(w) - tr(A)| in units of n eps32 max|A| (bench_sections.py:498)."""
    trace = abs(float(w.double().sum()) - float(a.diagonal().double().sum()))
    return trace / (a.shape[0] * EPS32 * float(a.abs().max()))


@contextlib.contextmanager
def _patched(mod, name, wrap):
    real = getattr(mod, name)
    setattr(mod, name, wrap(real))
    try:
        yield
    finally:
        setattr(mod, name, real)


def _drop_stage2_tau(real):
    """Planted fault: the recorded stage-2 reflector (n/2, 0) lost (tau 0)."""
    def chase(strips, n, b, lo, chunk):
        d, e, vs, taus = real(strips, n, b, lo, chunk)
        if lo <= n // 2 < lo + chunk:
            taus[n // 2 - lo, 0] = 0
        return d, e, vs, taus
    return chase


def _scale_stage1_tau(real):
    """Planted fault: one stage-1 reflector (panel 2, column 5) not unitary,
    its tau scaled by 1.1 where the panel QR makes it, so the band, the
    eigenvalues and the back-transform all see it."""
    calls = [0]

    def qr(panel):
        v, taus, r = real(panel)
        if calls[0] == 2:
            taus = taus.clone()
            taus[5] *= 1.1
        calls[0] += 1
        return v, taus, r
    return qr


def _shift_diagonal(real):
    """Planted fault: one diagonal entry of the tridiagonal off by 2 (about
    1% of ||A|| at n = 32768), as a faulty stage 2 would leave it."""
    def solve(d, e, laed4):
        d = d.clone()
        d[d.shape[0] // 2] += 2.0
        return real(d, e, laed4)
    return solve


def _capture_stage4(store):
    """bt_band_to_tridiag that keeps, for the shifted apply, a copy of the
    buffer it is given and the record (for the stage-4 comparison)."""
    def wrap(real):
        def bt(buf, vs, taus, b, **kw):
            if kw.get("shifted"):
                store.update(ep2=buf.clone(), vs=vs, taus=taus)
            return real(buf, vs, taus, b, **kw)
        return bt
    return wrap


def _keep_heaviest(store, chases, copy_buffer: bool):
    """Wraps a K4/K5 wrapper so that it keeps the arguments of its call with
    the most chases (``chases(*args)``) in ``store``, and with
    ``copy_buffer`` a copy of the buffer that call was given; it launches as
    before."""
    def wrap(real):
        def call(ep2, *args):
            c = chases(*args)
            if c > store.get("chases", -1):
                store.update(chases=c, args=args, ep2=ep2.clone() if copy_buffer else None)
            return real(ep2, *args)
        return call
    return wrap


def _k5_chases(v, v2, beta, nact, v0p, k, b) -> int:
    return sum(v0p + i for i in range(nact))


def _k4_chases(v, v2, base_blk, ncvalid, b) -> int:
    return ncvalid


@contextlib.contextmanager
def _plain_stage4():
    """Stage 4's shifted apply through K4/K5's plain versions."""
    with _patched(btm, "bt_apply_group", lambda real: bt_apply_group_ref), \
            _patched(btm, "bt_apply_fused", lambda real: bt_apply_fused_ref):
        yield


def _bt_bound(slabs, nev, b, blocks) -> dict:
    """K4/K5's bound: the flops the chases need, 2 nev per nonzero of each
    chase's V and V2 (V, the staggered WY trapezoid, has b nonzero rows of
    2b in each column, V2 = V T^H about 1.5 b^2 nonzeros: 5 b^2 nev flops a
    chase, where a dense 2b x b pair would count 8), run as the kernels run
    them, in three TF32 passes (6 flops a needed product term) at the
    tensor cores' TF32 peak; or the touched E blocks read and written once
    plus those nonzeros read once, over HBM bandwidth. ``bound_ms`` is the
    larger; the f32 FFMA bound of the same flops is kept beside it.
    ``slabs``: the (V, V2) pairs of the chases run."""
    nnz = sum(int(torch.count_nonzero(v)) + int(torch.count_nonzero(v2)) for v, v2 in slabs)
    flops = 2.0 * nev * nnz
    nbytes = 4.0 * (2 * blocks * b * nev + nnz)
    ms = {"operations": 3 * flops / PEAK_TF32 * 1e3, "bytes": nbytes / PEAK_BYTES * 1e3}
    by = max(ms, key=ms.get)
    return {"bound_ms": ms[by], "bound_by": by, "bound_tf32x3_ms": ms[by],
            "bound_f32_ffma_ms": max(flops / PEAK_F32 * 1e3, ms["bytes"]), "flops": flops}


def _err_eps(got, want, scale) -> float:
    return float((got - want).abs().max()) / (EPS32 * scale)


def _padded_copy(ep2, n, b):
    """The unshifted E of the shifted buffer, padded for the cooked route."""
    y = torch.zeros((n + 2 * b - 1, n), device=DEV)
    y[1:n] = ep2[:n - 1]
    return y


def _stage4_and_kernel_times(store, b) -> dict:
    """The captured n = 32768 stage 4: the whole apply through K5 against
    the cooked cuBLAS route and against K4/K5's plain versions (two
    torch.matmul per chase, cuBLAS) on the same record, each timed and
    compared entry by entry; K5 held to its plain version on the heaviest
    step that stage 4 launched (its arguments kept as it ran), K4 on the
    group of sweeps 0..b-1 (256 chases); both timed beside their plain
    version, bound and the cooked route of the same groups."""
    ep2, vs, taus = store["ep2"], store["vs"], store["taus"]
    n = ep2.shape[0] - 2 * b
    scale = float(ep2.abs().max())
    r = {}
    heavy = {}
    x = ep2.clone()
    with _patched(btm, "bt_apply_fused", _keep_heaviest(heavy, _k5_chases, False)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bt_band_to_tridiag(x, vs, taus, b, group_size=b, shifted=True)
        torch.cuda.synchronize()
        r["stage4_kernel_s"] = time.perf_counter() - t0
    y = _padded_copy(ep2, n, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bt_band_to_tridiag(y, vs, taus, b, group_size=b, prepadded=True)
    torch.cuda.synchronize()
    r["stage4_cublas_s"] = time.perf_counter() - t0
    r["stage4_kernel_vs_cublas_eps"] = _err_eps(x[:n - 1], y[1:n], scale)
    del y
    z = ep2.clone()
    with _plain_stage4():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bt_band_to_tridiag(z, vs, taus, b, group_size=b, shifted=True)
        torch.cuda.synchronize()
        r["stage4_plain_s"] = time.perf_counter() - t0
    r["stage4_kernel_vs_plain_eps"] = _err_eps(x, z, scale)
    del x, z
    # K5: the heaviest step stage 4 launched (groups 0..7, 2,020 chases)
    v, v2, beta, nact, v0p, k, _ = heavy["args"]
    got = bt_apply_fused(ep2.clone(), *heavy["args"])
    want = bt_apply_fused_ref(ep2.clone(), *heavy["args"])
    r["k5_real_step_err_eps"] = _err_eps(got, want, scale)
    r["k5_real_step_split"] = _split_faults("K5", ep2, v, v2, (beta, nact, v0p, k), b, want,
                                            scale)
    del got, want
    x = ep2.clone()
    y = _padded_copy(ep2, n, b)
    sweeps = slice(beta * b, (beta + nact) * b)   # the step's groups (one record: sweep_lo 0)
    r["k5"] = {"shape": [n, b, k, v0p + nact - 1], "chases": heavy["chases"],
               "ms": cuda_ms(lambda: bt_apply_fused(x, *heavy["args"]), 3),
               "plain_ms": cuda_ms(lambda: bt_apply_fused_ref(x, *heavy["args"]), 1),
               "cooked_ms": cuda_ms(lambda: bt_band_to_tridiag(
                   y, vs[sweeps], taus[sweeps], b, group_size=b, sweep_lo=sweeps.start,
                   prepadded=True), 1)}
    r["k5"].update(_bt_bound([(v[:v0p + i, i], v2[:v0p + i, i]) for i in range(nact)], n, b,
                             v0p + nact))
    del v, v2, heavy
    # K4: the group with the most chases (sweeps 0..b-1, 256 chases)
    nc = vs.shape[1]
    v, v2 = btm._group_vt_all(vs, taus, 0, b, b, nc, None)
    got = bt_apply_group(ep2.clone(), v, v2, 0, nc, b)
    want = bt_apply_group_ref(ep2.clone(), v, v2, 0, nc, b)
    r["k4_real_group_err_eps"] = _err_eps(got, want, scale)
    del got, want
    r["k4"] = {"shape": [n, b, nc], "chases": nc,
               "ms": cuda_ms(lambda: bt_apply_group(x, v, v2, 0, nc, b), 3),
               "plain_ms": cuda_ms(lambda: bt_apply_group_ref(x, v, v2, 0, nc, b), 1),
               "cooked_ms": cuda_ms(lambda: bt_band_to_tridiag(
                   y, vs[:b], taus[:b], b, group_size=b, prepadded=True), 1)}
    r["k4"].update(_bt_bound([(v, v2)], n, b, nc + 1))
    return r


def phase_eigh_large_main() -> None:
    """eigh_large at n = 32768 f32, band 128, rec_chunks = 1 (stage 4 through
    K5): a small warm-up, one run with timers (stage seconds and peak
    memory), one timed run (which also keeps a copy of stage 4's input: one
    4 GiB copy, ~3 ms), the probe and trace gates beside planted faults
    (each a whole call at n = 8192), the whole stage 4 against the cooked cuBLAS route
    and K4/K5's plain versions on the same record, and K4/K5 held to their
    plain versions and timed on that record."""
    n, b = N_LARGE, B_LARGE
    large.eigh_large(_eigh_input(torch.float32)[:1024, :1024].contiguous(), band=b)
    a = gen.random_hermitian(torch.Generator(device=DEV).manual_seed(LARGE_SEED), n,
                             torch.float32)
    # the run with timers first, with nothing but the input held, so that
    # its peaks are the call's own
    torch.cuda.empty_cache()
    base_gib = torch.cuda.memory_allocated() / 2**30
    w2, v2, stages = large.eigh_large(a, band=b, timers=True)
    peaks = {k: x / 2**30 for k, x in large.stage_peak_bytes.items()}
    store = {}
    _count_reset()
    with _patched(large, "bt_band_to_tridiag", _capture_stage4(store)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w, v = large.eigh_large(a, band=b)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches = _counts()
    KERNELS["bt_apply_fused"]["launches"] = launches["bt_apply_fused"]
    same = {"w": torch.equal(w, w2), "v": torch.equal(v, v2)}
    del w2, v2
    readings = _large_gates(a, w, v)
    del v
    # the planted faults, each a whole call, at n = N_PLANTED_LARGE: the
    # gates' units scale with n, so a fault reads at least as high there
    planted = {"n": N_PLANTED_LARGE}
    a_p = gen.random_hermitian(torch.Generator(device=DEV).manual_seed(LARGE_SEED),
                               N_PLANTED_LARGE, torch.float32)
    with _patched(large, "_chase", _drop_stage2_tau):
        wb, vb = large.eigh_large(a_p, band=b)
    planted["stage2_tau_dropped"] = _large_gates(a_p, wb, vb)
    del wb, vb
    with _patched(r2b, "panel_qr", _scale_stage1_tau):
        wb, vb = large.eigh_large(a_p, band=b)
    planted["stage1_tau_scaled"] = _large_gates(a_p, wb, vb)
    del wb, vb
    with _patched(large, "tridiag_eigh", _shift_diagonal):
        planted["tridiag_diagonal_shifted_trace"] = _trace_reading(
            a_p, large.eigvalsh_large(a_p, band=b))
    del a_p
    st4 = _stage4_and_kernel_times(store, b)
    del store
    emit("eigh_large_main", n=n, band=b, dtype="float32", rec_chunks=1, seconds=secs,
         stage_seconds=stages, stage_peak_gib=peaks, input_gib=base_gib, launches=launches,
         bit_equal=same,
         readings=readings, bounds=LARGE_BOUNDS, planted_fault_readings=planted,
         stage4=st4, nvidia_smi=smi_line())
    require(launches["bt_apply_fused"] > 0 and launches["band_to_tridiag_strips"] > 0,
            f"eigh_large n={n} launched K3 and K5 ({launches})")
    require(same["w"], "eigh_large's timed and staged runs give the same w")
    require(readings["finite"] and readings["ascending"], f"eigh_large n={n}: {readings}")
    for k, bound in LARGE_BOUNDS.items():
        require(readings[k] <= bound, f"eigh_large n={n}: {k} {readings[k]} > {bound}")
    require(planted["stage2_tau_dropped"]["res"] > LARGE_BOUNDS["res"],
            f"the res gate passes a planted fault ({planted})")
    require(planted["stage1_tau_scaled"]["orth"] > LARGE_BOUNDS["orth"],
            f"the orth gate passes a planted fault ({planted})")
    require(planted["tridiag_diagonal_shifted_trace"] > LARGE_BOUNDS["trace"],
            f"the trace gate passes a planted fault ({planted})")
    require(st4["stage4_kernel_vs_cublas_eps"] <= STAGE4_BOUND,
            f"stage 4 through K5 against the cuBLAS route: {st4['stage4_kernel_vs_cublas_eps']}")
    require(st4["stage4_kernel_vs_plain_eps"] <= STAGE4_BOUND,
            f"stage 4 through K5 against the plain versions: {st4['stage4_kernel_vs_plain_eps']}")
    for key in ("k5_real_step_err_eps", "k4_real_group_err_eps"):
        require(st4[key] <= K45_BOUND, f"on the real n = {n} record, {key}: {st4[key]}")
    require(min(st4["k5_real_step_split"].values()) > K45_BOUND,
            f"on the real n = {n} record, the K5 check passes a one- or two-term TF32 split "
            f"({st4['k5_real_step_split']})")
    for name, key in (("bt_apply_group", "k4"), ("bt_apply_fused", "k5")):
        t = st4[key]
        # the library route: the faster of two cuBLAS routes of the same
        # chases, the plain version's two torch.matmul per chase and the
        # cooked grouped apply's three
        lib = min(("plain", "cooked"), key=lambda r: t[f"{r}_ms"])
        KERNELS[name].update(ms=t["ms"], plain_ms=t["plain_ms"], library_ms=t[f"{lib}_ms"],
                             cooked_ms=t["cooked_ms"], bound_ms=t["bound_ms"],
                             bound_by=t["bound_by"], bound_tf32x3_ms=t["bound_tf32x3_ms"],
                             bound_f32_ffma_ms=t["bound_f32_ffma_ms"], timed_shape=t["shape"],
                             library={"plain": "two torch.matmul per chase (cuBLAS)",
                                      "cooked": "the cooked grouped apply, three "
                                                "torch.matmul per chase (cuBLAS)"}[lib])


def phase_eigh_large_cases() -> None:
    """eigh_large against dt.eigh on the same matrix: w bit-equal (stages 1-3
    are the same calls), both held to the eigh gates; eigvalsh_large's w
    bit-equal to eigh_large's at n = 9984. K4's launches on the slice's
    path are read from the n = 9984 run."""
    b = B_LARGE
    for n, chunks, dtype in LARGE_CASES:
        a = gen.random_hermitian(torch.Generator(device=DEV).manual_seed(n + chunks), n, dtype)
        a64 = a.to(_wide(dtype))
        w64 = torch.linalg.eigvalsh(a64)
        k4 = {}
        _count_reset()
        with _patched(btm, "bt_apply_group", _keep_heaviest(k4, _k4_chases, True)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            w, v = large.eigh_large(a, band=b, rec_chunks=chunks)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        launches = _counts()
        w1, v1 = dt.eigh(a, band=b)
        r = {"large": _eigh_readings(a64, w, v, w64), "eigh": _eigh_readings(a64, w1, v1, w64),
             "w_bit_equal_to_eigh": torch.equal(w, w1),
             "w_max_diff": float((w - w1).abs().max())}
        del v, v1
        if k4:   # the peeled K4 call with the most chases, on the buffer it was given
            ep2 = k4["ep2"]
            got = bt_apply_group(ep2.clone(), *k4["args"])
            want = bt_apply_group_ref(ep2, *k4["args"])
            r["k4_peeled"] = {"chases": k4["chases"], "base_blk": k4["args"][2],
                              "err_eps": _err_eps(got, want, float(ep2.abs().max()))}
            del got, want, ep2, k4
        if n == LARGE_CASES[0][0]:
            KERNELS["bt_apply_group"]["launches"] = launches["bt_apply_group"]
            r["eigvalsh_large_bit_equal"] = torch.equal(large.eigvalsh_large(a, band=b), w)
        emit("eigh_large_case", n=n, band=b, rec_chunks=chunks,
             dtype=str(dtype).replace("torch.", ""), seconds=secs, launches=launches, **r)
        what = f"eigh_large n={n} rec_chunks={chunks} {dtype}"
        _eigh_gates(r["large"], what)
        require(r["w_bit_equal_to_eigh"], f"{what}: w equals dt.eigh's ({r['w_max_diff']})")
        require(("k4_peeled" in r) == (launches["bt_apply_group"] > 0), f"{what}: {launches}")
        if "k4_peeled" in r:
            require(r["k4_peeled"]["err_eps"] <= K45_BOUND, f"{what}: K4 {r['k4_peeled']}")
        require(launches["band_to_tridiag_strips"] == chunks + (chunks > 1),
                f"{what}: K3 launches {launches}")
        if dtype == torch.float32:
            require(launches["bt_apply_fused"] > 0, f"{what}: K5 launched ({launches})")
        else:
            require(launches["bt_apply_fused"] + launches["bt_apply_group"] == 0,
                    f"{what}: complex takes the cooked route ({launches})")
        if n == LARGE_CASES[0][0]:
            require(launches["bt_apply_group"] == 6 and launches["bt_apply_fused"] == 9,
                    f"{what}: 6 groups through K4, 9 K5 steps ({launches})")
            require(r["eigvalsh_large_bit_equal"], f"{what}: eigvalsh_large")
        del a, a64


def _timed_potrf(a) -> tuple[float, torch.Tensor]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f = dt.potrf(a, uplo="U", nb=NB_MAIN, clean=False)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, f


def _residual(f, a, uplo: str = "U") -> float:
    """max|U^T U - A| (max|L L^T - A| for L), in place on the factor
    (leaves triu(f), or tril(f), in f)."""
    if uplo == "U":
        u = f.triu_()
        r = u.T @ u
    else:
        low = f.tril_()
        r = low @ low.T
    return float(r.sub_(a).abs_().max())


def _set_route(route: str) -> None:
    leaf.set_leaf_backend(None if route == "kernel" else "torch")
    dt.set_tune_parameters(potrf_trailing_kernel=route)


@contextlib.contextmanager
def _planted_leaf(which: int):
    """Plain-route leaves, with leaf number ``which`` a planted fault."""
    calls = [0]

    def plain(t, upper=False):
        calls[0] += 1
        if calls[0] - 1 == which:
            return _planted(t, upper, t.shape[0] // 32 - 2)
        return potrf_tile_ref(t, upper)

    leaf.potrf_tile_ref = plain
    try:
        yield
    finally:
        leaf.potrf_tile_ref = potrf_tile_ref


def phase_main() -> None:
    """The slice at full size: upper POTRF at n = 32768 f32, nb = 512, in
    turns through the kernels and through the plain route. The kernel
    route's factor is held entry by entry to the plain route's, and so is
    a plain-route factor with one planted leaf fault, which must fail."""
    n = N_MAIN
    flops = n**3 / 3
    t0 = time.perf_counter()
    a = gen.random_hermitian_positive_definite(
        torch.Generator(device=DEV).manual_seed(0), n, torch.float32)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    bound = 100 * n * EPS32
    amax = float(a.abs().max())
    secs = {"kernel": [], "torch": []}
    res, res_k, dev = {}, {}, {}
    plain = None
    per_run = set()
    potrf_tile.launches = ksub_matmul.launches = 0
    for i, route in enumerate(["kernel", "torch", "torch", "kernel", "kernel", "torch"]):
        _set_route(route)
        before = (potrf_tile.launches, ksub_matmul.launches)
        t, f = _timed_potrf(a)
        after = (potrf_tile.launches, ksub_matmul.launches)
        if route == "torch":
            require(after == before, "the plain route launched a kernel")
        else:
            per_run.add((after[0] - before[0], after[1] - before[1]))
        if i >= 2:   # runs 0 and 1 are the warm-ups of each route
            secs[route].append(t)
        if route not in res and i >= 2:
            r = _residual(f, a)
            res[route], res_k[route] = r / n, r / (EPS32 * amax)
            require(res[route] <= bound, f"POTRF {route} residual {res[route]} > {bound}")
            require(res_k[route] <= RES_K, f"POTRF {route} residual {res_k[route]} "
                    f"eps max|A| > {RES_K}")
            if route == "torch":
                plain = f
            else:
                dev["kernel"] = factor_deviation(f, plain, ROUTE_C)
                require(dev["kernel"] <= 1.0, f"POTRF kernel route factor deviates "
                        f"from the plain route's: {dev['kernel']} > 1")
        del f
    launches = {"potrf_tile": potrf_tile.launches, "ksub_matmul": ksub_matmul.launches}
    require(launches["potrf_tile"] > 0 and launches["ksub_matmul"] > 0,
            f"main path launched every kernel: {launches}")
    require(len(per_run) == 1, f"every kernel-route POTRF launches the same: {per_run}")
    k1_run, k2_run = per_run.pop()
    for k, v in launches.items():
        KERNELS[k]["launches"] = v
    _set_route("torch")
    with _planted_leaf(n // NB_MAIN // 2):
        _, f = _timed_potrf(a)
    dev["planted_leaf"] = factor_deviation(f.triu_(), plain, ROUTE_C)
    require(dev["planted_leaf"] > 1.0, "the route check passes a planted leaf fault "
            f"({dev['planted_leaf']})")
    leaf.set_leaf_backend(None)
    dt.reset_tune_parameters()
    del a, f, plain
    torch.cuda.empty_cache()
    ng = GEMM_N
    b = gen.random_general(torch.Generator(device=DEV).manual_seed(3), (ng, ng), torch.float32)
    gemm_ms = cuda_ms(lambda: b @ b, 3)
    del b
    best = {r: min(v) for r, v in secs.items()}
    emit("potrf_main", n=n, nb=NB_MAIN, uplo="U", dtype="float32", clean=False,
         gen_seconds=gen_s, seconds=secs,
         tflops={r: flops / t / 1e12 for r, t in best.items()},
         residual=res, residual_bound=bound, residual_eps_max_a=res_k,
         residual_eps_max_a_bound=RES_K, factor_deviation=dev,
         factor_bound=f"|U_kernel-U_torch| <= {ROUTE_C} eps32 (|U_torch| + max offdiag)",
         launches=launches, launches_per_run={"potrf_tile": k1_run, "ksub_matmul": k2_run},
         gemm_f32_n=ng, gemm_f32_tflops=2 * ng**3 / gemm_ms / 1e9,
         allow_tf32=torch.backends.cuda.matmul.allow_tf32)


def _miniapp(argv, mod=miniapp_cholesky) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main(argv)
    return buf.getvalue()


def phase_miniapp() -> None:
    potrf_tile.launches = 0
    out = _miniapp(["-n", MINIAPP_N, "-b", "256", "--uplo", "L", "--check", "--nruns", "1"])
    require("check: PASSED" in out, "miniapp f32 check")
    k1 = potrf_tile.launches
    require(k1 > 0, "miniapp f32 ran K1")
    out_d = _miniapp(["-n", MINIAPP_N, "-b", "256", "--type", "d", "--check", "--nruns", "1"])
    require("check: PASSED" in out_d, "miniapp f64 check")
    emit("miniapp", s=out.strip().splitlines(), d=out_d.strip().splitlines(), k1_launches=k1)


def phase_info() -> None:
    n, nb, bad = 4096, 512, 2500
    a = gen.random_hermitian_positive_definite(
        torch.Generator(device=DEV).manual_seed(5), n, torch.float32)
    _, info_ok = dt.potrf_info(a, uplo="U", nb=nb)
    a[bad, bad] = -1.0
    got = {}
    for uplo in ("U", "L"):
        _, info = dt.potrf_info(a, uplo=uplo, nb=nb)
        got[uplo] = int(info)
        tile = bad // nb
        require(tile * nb < got[uplo] <= (tile + 1) * nb,
                f"potrf_info {uplo}: info {got[uplo]} outside the failing tile")
    require(int(info_ok) == 0, "potrf_info on an SPD matrix")
    # a NaN pair off the diagonal inside leaf tile 4: the JAX package
    # reports the first non-finite pivot, row nan_at[0] + 1 (its leaf's NaN
    # flows forward); K1 propagates NaN forward too, and the plain route's
    # leaf (potrf_tile_ref) NaNs the columns from cholesky_ex's failing
    # pivot on. Each route's info, which must lie in the failing tile.
    nan_at = (bad + 7, bad - 3)
    a = gen.random_hermitian_positive_definite(
        torch.Generator(device=DEV).manual_seed(5), n, torch.float32)
    a[nan_at] = a[nan_at[::-1]] = float("nan")
    nan_info = {}
    for route in ("kernel", "torch"):
        _set_route(route)
        try:
            nan_info[route] = {u: int(dt.potrf_info(a, uplo=u, nb=nb)[1]) for u in "UL"}
        finally:
            _set_route("kernel")
    tile = nan_at[0] // nb
    for route, infos in nan_info.items():
        for u, info in infos.items():
            require(tile * nb < info <= (tile + 1) * nb,
                    f"potrf_info {route} {u} on a NaN entry: info {info} outside the failing tile")
    # the distributed Cholesky (1x1, n = 16384, so that the trailing
    # updates take K6's pipelined route, not split-k) with the NaN pair off
    # the diagonal tiles, in tile (5, 1): the panel's NaN row reaches the
    # trailing matrix through K6, and a pivot of the NaN's row tile turns
    # NaN on both routes
    far_at = (5 * nb + nb // 2 + 7, nb + nb // 2 + 3)
    a = gen.random_hermitian_positive_definite(
        torch.Generator(device=DEV).manual_seed(5), 16384, torch.float32)
    a[far_at] = a[far_at[::-1]] = float("nan")
    dist_info = {}
    for route in ("kernel", "torch"):
        _set_route(route)
        try:
            piped0 = ksub_matmul_masked.pipelined
            dist_info[route] = int(dt.cholesky_info(dt.DistMatrix.from_global(
                a, nb, dt.Grid((1, 1))))[1])
            piped = ksub_matmul_masked.pipelined - piped0
        finally:
            _set_route("kernel")
        tile = far_at[0] // nb
        require(tile * nb < dist_info[route] <= (tile + 1) * nb,
                f"cholesky_info {route} on a NaN off the diagonal tiles: info "
                f"{dist_info[route]} outside tile {tile}")
        require(route == "torch" or piped > 0, "cholesky_info: no K6 launch on the pipelined route")
    emit("potrf_info", n=n, nb=nb, bad_index=bad, info=got, info_spd=int(info_ok),
         nan_entry=list(nan_at), nan_info=nan_info, nan_first_nonfinite_pivot=nan_at[0] + 1,
         nan_info_kernel_equals_plain=nan_info["kernel"] == nan_info["torch"],
         dist_nan_n=16384, dist_nan_entry=list(far_at), dist_nan_info=dist_info)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


def _k6_bound(c, y, gr, gc) -> tuple[float, str, dict]:
    """The least time of one K6 call at its own arithmetic's rate: the
    tensor-core operations its kept entries need (three TF32 passes, 6k
    each) over the TF32 peak, or its bytes (c read and written, x, y and
    the index vectors read once) over HBM bandwidth, whichever is larger.
    Beside it, the f32 FFMA bound of the same 2k a kept entry, and the
    flops of the live 128 x 128 tiles, the work the kernel does (it skips
    the dead ones)."""
    m, n = c.shape
    k = y.shape[0]
    kept = int((gr >= gc).sum())
    t = 128
    rmax = torch.full((-(-m // t) * t,), -2**31, dtype=torch.int64, device=c.device)
    cmin = torch.full((-(-n // t) * t,), 2**31, dtype=torch.int64, device=c.device)
    rmax[:m], cmin[:n] = gr.reshape(-1), gc.reshape(-1)
    live = rmax.view(-1, t).amax(1)[:, None] >= cmin.view(-1, t).amin(1)[None, :]
    rows = torch.clamp(m - torch.arange(0, m, t, device=c.device), max=t)
    cols = torch.clamp(n - torch.arange(0, n, t, device=c.device), max=t)
    live_entries = int((live * rows[:, None] * cols[None, :]).sum())
    nbytes = 4 * (2 * m * n + (m + n) * k + m + n)
    ms = {"operations": 6 * k * kept / PEAK_TF32 * 1e3, "bytes": nbytes / PEAK_BYTES * 1e3}
    by = max(ms, key=ms.get)
    return ms[by], by, {"kept_entries": kept, "flops": 2 * k * kept, "bytes": nbytes,
                        "bound_tf32x3_ms": ms[by],
                        "bound_f32_ffma_ms": max(2 * k * kept / PEAK_F32 * 1e3, ms["bytes"]),
                        "live_tile_flops": 2 * k * live_entries,
                        "live_tile_bound_ms": 6 * k * live_entries / PEAK_TF32 * 1e3}


def _k6_case(name, c, x, y, gr, gc, kmaj, outside=None, splits=False, pipelined=True) -> dict:
    """K6 on (c, x, y) against its plain version in f64, in place on ``c``
    (a view), and each check beside a planted fault it must reject:

      - max|K6 - f64| <= eps32 (2k max|x| max|y| + max|c|) (K2's bound),
        shown the plain result with one live tile's mask inverted and, with
        ``splits``, K6's split cut to one TF32 term and to two under the
        mask (emulated on the card);
      - the entries outside the mask bit-equal to the input, shown one of
        them moved by one ulp;
      - a second run on the same input bit-identical to the first;
      - ``outside``, a view of the buffer next to ``c``, left unchanged;
      - both runs on the pipelined route where ``pipelined`` (X (m, k),
        16-byte aligned operands, no k split), else on the route before it
        (``ksub_matmul_masked.pipelined``).
    """
    m, n = c.shape
    k = y.shape[0]
    plan = ksub_matmul_plan(c, x, y, kmaj)
    c0 = c.clone()
    piped0 = ksub_matmul_masked.pipelined
    out0 = outside.clone() if outside is not None else None
    keep = (gr >= gc).expand(m, n)
    want = ksub_matmul_masked_ref(c0.double(), x.double(), y.double(), gr, gc, kmaj)
    ksub_matmul_masked(c, x, y, gr, gc, x_k_major=kmaj)
    got = c.clone()
    c.copy_(c0)
    ksub_matmul_masked(c, x, y, gr, gc, x_k_major=kmaj)
    piped = ksub_matmul_masked.pipelined - piped0
    bound = EPS32 * (2 * k * float(x.abs().max()) * float(y.abs().max()) + float(c0.abs().max()))
    r = {"m": m, "n": n, "k": k, "x_k_major": kmaj, "ldc": c.stride(0), "plan": plan,
         "pipelined_runs": piped,
         "kept_share": float(keep.float().mean()), "bound": bound,
         "max_abs_err": float((got.double() - want).abs().max()),
         "masked_out_bit_equal": bool(torch.equal(torch.where(keep, 0, _bits(got)),
                                                  torch.where(keep, 0, _bits(c0)))),
         "bit_identical": bool(torch.equal(_bits(got), _bits(c))),
         "outside_unchanged": outside is None or bool(torch.equal(outside, out0))}
    if bool(keep.any()):
        # the plain result with the mask of the first kept entry's tile inverted
        i, j = (int(v) // 128 * 128 for v in keep.nonzero()[0])
        xs = (x.T if kmaj else x)[i:i + 128].double()
        full = c0[i:i + 128, j:j + 128].double() - xs @ y[:, j:j + 128].double()
        bad = want.clone()
        bad[i:i + 128, j:j + 128] = torch.where(keep[i:i + 128, j:j + 128],
                                                c0[i:i + 128, j:j + 128].double(), full)
        r["planted_fault_err"] = float((bad - want).abs().max())
    if splits:
        for t in (1, 2):
            r[f"planted_{t}_term_err"] = float(
                (ksub_matmul_masked_split_ref(c0, x, y, gr, gc, kmaj, terms=t).double()
                 - want).abs().max())
    if not bool(keep.all()):
        # one entry outside the mask one ulp off
        i, j = (int(v) for v in (~keep).nonzero()[0])
        bad = got.clone()
        bad[i, j] = torch.nextafter(bad[i, j], torch.tensor(float("inf"), device=c.device))
        r["planted_fault_masked_out_bit_equal"] = bool(
            torch.equal(torch.where(keep, 0, _bits(bad)), torch.where(keep, 0, _bits(c0))))
    emit("k6", case=name, **r)
    require(r["max_abs_err"] <= bound, f"K6 {name}: {r['max_abs_err']} > {bound}")
    require(r["masked_out_bit_equal"], f"K6 {name}: entries outside the mask changed")
    require(r["bit_identical"] and r["outside_unchanged"], f"K6 {name}: {r}")
    require(piped == (2 if pipelined else 0),
            f"K6 {name}: {piped} of 2 runs on the pipelined route, want {2 if pipelined else 0}")
    require(r.get("planted_fault_err", bound + 1) > bound,
            f"K6 {name}: the error check passes an inverted tile mask")
    for t in (1, 2):
        require(r.get(f"planted_{t}_term_err", bound + 1) > bound,
                f"K6 {name}: the error check passes a {t}-term TF32 split")
    require(not r.get("planted_fault_masked_out_bit_equal", False),
            f"K6 {name}: the bit check passes a changed entry")
    return r


def _strided_buf(g, rows, cols, pad):
    """A (rows, cols) view with leading dimension cols + pad, unaligned, and
    the pad columns beside it."""
    buf = gen.random_general(g, (rows, cols + pad), torch.float32)
    return buf[:, pad:], buf[:, :pad]


def phase_k6() -> None:
    """K6 against its plain version: the distributed POTRF's own shapes at
    n = 32768 (views into one n x n buffer, leading dimension n; the
    heaviest chunks beside the one- and two-term TF32 splits), the 2x2
    grid's index pattern on ragged row-strided views in both layouts (the
    4-byte copy path), the split-k cluster path with dead and live clusters,
    and all-dead inputs (bit-unchanged), each on the route it must take
    (the pipelined one for the aligned X (m, k) launches without a k
    split); then the heaviest chunk timed."""
    g = torch.Generator(device=DEV).manual_seed(8)
    n, nb = N_MAIN, NB_MAIN
    m, w, k = K6_CHUNK
    r0 = n - m
    idx = torch.arange(n, device=DEV, dtype=torch.int32)
    big = gen.random_general(g, (n, n), torch.float32)
    rnd = functools.partial(gen.random_general, g, dtype=torch.float32)
    worst = {"max_abs_err": 0.0, "bound": 0.0}

    def keep(r):
        if r["max_abs_err"] > worst["max_abs_err"]:
            worst.update(max_abs_err=r["max_abs_err"], bound=r["bound"])

    # the heaviest lower staircase chunk: a[t0*nb:, c0*nb:c1*nb] -= wide @ wide_t
    cL, xL, yL = big[r0:, r0:r0 + w], rnd((m, k)), rnd((k, m))[:, :w]
    grL, gcL = idx[r0:, None], idx[None, r0:r0 + w]
    keep(_k6_case("chunk_lower_heaviest", cL, xL, yL, grL, gcL, False, splits=True))
    # a panel-step update (kt = 0): the panel's last 512 columns carry the sentinel
    cols = torch.arange(nb, 4 * nb, device=DEV, dtype=torch.int32)
    keep(_k6_case("panel_step_sentinel", big[:, nb:4 * nb], rnd((n, nb)),
                  rnd((nb, n))[:, nb:4 * nb], idx[:, None],
                  torch.where(cols < 3 * nb, cols, K6_SENTINEL)[None, :], False))
    # the heaviest upper staircase chunk, i <= j on negated indices
    keep(_k6_case("chunk_upper_heaviest", big[r0:r0 + w, r0:], rnd((m, k))[:w],
                  rnd((k, n))[:, r0:], -idx[r0:r0 + w, None], -idx[None, r0:], False,
                  splits=True))
    # rank (1, 0) of a 2x2 grid (64-row tiles): ragged, unaligned row-strided views
    gr22 = global_indices(16, 64, 2, 1, DEV)[:1000, None].int()
    gc22 = global_indices(13, 64, 2, 0, DEV)[None, :777].int()
    for kmaj, pad in ((True, 3), (False, 5)):
        c, side = _strided_buf(g, 1000, 777, pad)
        x = _strided_buf(g, 1234, 1000, pad)[0] if kmaj else _strided_buf(g, 1000, 1234, pad)[0]
        keep(_k6_case(f"grid2x2_ragged_kmajor{int(kmaj)}", c, x, _strided_buf(g, 1234, 777, pad)[0],
                      gr22, gc22, kmaj, outside=side, pipelined=False))
    # the split-k cluster path (6 output tiles, k = 5000), dead and live clusters
    c, side = _strided_buf(g, 300, 200, 2)
    ar = torch.arange(300, device=DEV, dtype=torch.int32)
    keep(_k6_case("split_k_mixed", c, _strided_buf(g, 300, 5000, 2)[0],
                  _strided_buf(g, 5000, 200, 2)[0], (2 * ar)[:, None],
                  (3 * ar[:200] + 100)[None, :], False, outside=side, pipelined=False))
    # all tiles dead, through the split path (16 tiles) and the unsplit one
    for mm, kk in ((512, 512), (4096, 512)):
        ar = torch.arange(mm, device=DEV, dtype=torch.int32)
        keep(_k6_case(f"all_dead_{mm}", rnd((mm, mm)), rnd((mm, kk)), rnd((kk, mm)),
                      ar[:, None], (ar + mm)[None, :], False, pipelined=mm > 512))
    del big
    torch.cuda.empty_cache()

    # the heaviest chunk, timed (the n40960 cell's chunks: torch_chip_probes.py k6_levers)
    piped0 = ksub_matmul_masked.pipelined
    ms = cuda_ms(lambda: ksub_matmul_masked(cL, xL, yL, grL, gcL, x_k_major=False), 5)
    require(ksub_matmul_masked.pipelined - piped0 == 6, "K6 timed off the pipelined route")
    plain_ms = cuda_ms(lambda: ksub_matmul_masked_ref(cL, xL, yL, grL, gcL, False), 5)
    library_ms = cuda_ms(lambda: torch.addmm(cL, xL, yL, alpha=-1), 5)
    bound_ms, bound_by, work = _k6_bound(cL, yL, grL, gcL)
    # FFMA-equivalent rate (2k a kept entry) and the tensor cores' share of
    # their TF32 peak (three passes, 6k a kept entry)
    tflops = work["flops"] / ms / 1e9
    emit("k6_time", m=m, n=w, k=k, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
         library="torch.addmm (unmasked)", bound_ms=bound_ms, bound_by=bound_by,
         tflops=tflops, of_f32_peak=tflops * 1e12 / PEAK_F32, tensor_tflops=3 * tflops,
         of_tf32_peak=3 * tflops * 1e12 / PEAK_TF32, plan=ksub_matmul_plan(cL, xL, yL, False),
         route="pipelined", **work)
    del cL, xL, yL
    KERNELS.setdefault("ksub_matmul_masked", {}).update(
        name="ksub_matmul_masked", route="cuda", source="dlaf_tpu_torch/csrc/ksub_tf32x3.cu",
        replaces="dlaf_tpu/ops/pallas/trailing.py:147", max_abs_err=worst["max_abs_err"],
        bound=worst["bound"], ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        bound_tf32x3_ms=work["bound_tf32x3_ms"], bound_f32_ffma_ms=work["bound_f32_ffma_ms"],
        library_ms=library_ms, timed_shape=[m, w, k])
    torch.cuda.empty_cache()


def _counters() -> dict:
    return {"potrf_tile": potrf_tile.launches, "ksub_matmul": ksub_matmul.launches,
            "ksub_matmul_masked": ksub_matmul_masked.launches,
            "ksub_matmul_masked_pipelined": ksub_matmul_masked.pipelined,
            "band_to_tridiag_strips": band_to_tridiag_strips_kernel.launches,
            "bt_apply_group": bt_apply_group.launches, "bt_apply_fused": bt_apply_fused.launches}


def _counters_reset() -> None:
    potrf_tile.launches = ksub_matmul.launches = ksub_matmul_masked.launches = 0
    ksub_matmul_masked.pipelined = 0
    _count_reset()


def _other_kept(f, a, uplo) -> bool:
    """The factor's strict other triangle bit-equal to the input's, by
    2048-row blocks."""
    for i in range(0, a.shape[0], 2048):
        tri = (lambda t: torch.triu(t, i + 1)) if uplo == "L" else (lambda t: torch.tril(t, i - 1))
        if not torch.equal(_bits(tri(f[i:i + 2048])), _bits(tri(a[i:i + 2048]))):
            return False
    return True


def _timed_cholesky(dm, uplo) -> tuple[float, torch.Tensor]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f = dt.cholesky(dm, uplo=uplo).data
    torch.cuda.synchronize()
    return time.perf_counter() - t0, f


def phase_dist_main() -> None:
    """The slice at full size: ``cholesky`` on a 1x1 grid at n = 32768 f32,
    nb = 512, L then U, in turns through K1 + K6 and through the plain
    route. Per uplo: the residual gate, the kernel route's factor against
    the plain route's entry by entry (shown a plain-route factor with one
    planted leaf fault), the other triangle bit-equal to the input (shown
    one of its entries moved), K1 and K6 launched on every kernel-route
    run (counts reset before each run and read after it), none on the
    plain route; and the local ``potrf`` beside it."""
    n, nb = N_MAIN, NB_MAIN
    a = gen.random_hermitian_positive_definite(
        torch.Generator(device=DEV).manual_seed(0), n, torch.float32)
    dm = dt.DistMatrix.from_global(a, nb, dt.Grid((1, 1)))
    amax = float(a.abs().max())
    flops = n**3 / 3
    report = {}
    for uplo in ("L", "U"):
        secs = {"kernel": [], "torch": []}
        res_k, dev, launches = {}, {}, []
        plain = None
        for i, route in enumerate(ROUTE_TURNS):
            _set_route(route)
            _counters_reset()
            t, f = _timed_cholesky(dm, uplo)
            counts = _counters()
            if route == "torch":
                require(not any(counts.values()), f"dist {uplo}: the plain route launched {counts}")
            else:
                launches.append(counts)
            if i >= 2:
                secs[route].append(t)
            if route in res_k or i < 2:
                del f
                continue
            kept = _other_kept(f, a, uplo)
            j = (0, n - 1) if uplo == "L" else (n - 1, 0)
            f0 = f[j].clone()
            f[j] = torch.nextafter(f0, torch.tensor(float("inf"), device=DEV))
            planted_kept = _other_kept(f, a, uplo)
            f[j] = f0
            require(kept and not planted_kept,
                    f"dist {uplo} {route}: other triangle kept {kept}, planted {planted_kept}")
            res_k[route] = _residual(f, a, uplo) / (EPS32 * amax)
            require(res_k[route] <= RES_K, f"dist {uplo} {route}: residual {res_k[route]} "
                    f"eps max|A| > {RES_K}")
            if route == "torch":
                plain = f
            else:
                dev["kernel"] = factor_deviation(f, plain, ROUTE_C)
                require(dev["kernel"] <= 1.0, f"dist {uplo}: kernel route deviates from "
                        f"the plain route's factor: {dev['kernel']}")
            del f
        require(all(c == launches[0] for c in launches), f"dist {uplo}: launches vary {launches}")
        require(launches[0]["potrf_tile"] > 0 and launches[0]["ksub_matmul_masked"] > 0,
                f"dist {uplo}: the kernel route launched K1 and K6: {launches[0]}")
        _set_route("torch")
        with _planted_leaf(n // nb // 2):
            _, f = _timed_cholesky(dm, uplo)
        dev["planted_leaf"] = factor_deviation(f.tril_() if uplo == "L" else f.triu_(), plain,
                                               ROUTE_C)
        require(dev["planted_leaf"] > 1.0, f"dist {uplo}: the route check passes a planted "
                f"leaf fault ({dev['planted_leaf']})")
        del f, plain
        # the local POTRF on the same matrix, through the kernels
        _set_route("kernel")
        local = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f = dt.potrf(a, uplo=uplo, nb=nb, clean=False)
            torch.cuda.synchronize()
            local.append(time.perf_counter() - t0)
            del f
        best = {r: min(v) for r, v in secs.items()}
        report[uplo] = dict(seconds=secs, tflops={r: flops / t / 1e12 for r, t in best.items()},
                            local_seconds=local[1], local_tflops=flops / local[1] / 1e12,
                            dist_over_local=best["kernel"] / local[1],
                            residual_eps_max_a=res_k, factor_deviation=dev,
                            launches=launches[0])
        torch.cuda.empty_cache()
    leaf.set_leaf_backend(None)
    dt.reset_tune_parameters()
    emit("dist_main", n=n, nb=nb, grid=[1, 1], dtype="float32", routes=ROUTE_TURNS,
         residual_eps_max_a_bound=RES_K,
         factor_bound=f"|F_kernel-F_torch| <= {ROUTE_C} eps32 (|F_torch| + max offdiag)",
         **report)
    KERNELS.setdefault("ksub_matmul_masked", {}).update(
        launches=sum(report[u]["launches"]["ksub_matmul_masked"] for u in "LU"),
        launches_by_uplo={u: report[u]["launches"]["ksub_matmul_masked"] for u in "LU"})
    del a, dm
    torch.cuda.empty_cache()


def _checked(fn) -> dict:
    """``fn()`` under the collective-schedule checker: the findings, this
    rank's recorded calls (group collectives, send/receives) and the
    seconds, the device synchronised on both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with debug.record_schedule(check=True) as rec:
        fn()
        torch.cuda.synchronize()
    return {"seconds": time.perf_counter() - t0, "findings": rec.findings, "ops": len(rec.ops),
            "group": sum(op.prim != "sendrecv" and not op.local for op in rec.ops),
            "p2p": sum(op.prim == "sendrecv" and not op.local for op in rec.ops)}


def _plant_extra_allreduce(dm, grid):
    f = dt.cholesky(dm, uplo="L")
    if grid.rank == 1:
        coll.allreduce_sum(f.data[:1, :1], None, grid)


def _plant_skipped_bcast(dm, grid):
    real, calls = coll.bcast, [0]

    def skipping(x, owner, axis, g):
        calls[0] += 1
        return x if calls[0] == 3 else real(x, owner, axis, g)

    if grid.rank == 1:
        coll.bcast = skipping
    try:
        dt.cholesky(dm, uplo="L")
    finally:
        coll.bcast = real


def _plant_p2p_epoch(dm, grid):
    if grid.rank == 1:
        coll.allreduce_sum(dm.data[:1, :1], ROW_AXIS, grid)
    dm.transpose()


def _plant_stall(dm, grid):
    if grid.rank == 0:
        time.sleep(STALL_S)
    coll.allreduce_sum(dm.data[:1, :1], None, grid)


def _checks_and_plants(a, nb, grid) -> dict:
    """cholesky L and U unchecked, then under the checker (its K1/K6
    launches counted), then the planted divergences, on one rank of the
    2x2 grid."""
    out = {}
    for uplo in ("L", "U"):
        dm = dt.DistMatrix.from_global(a, nb, grid)
        unchecked_s = _timed_cholesky(dm, uplo)[0]
        potrf_tile.launches = ksub_matmul_masked.launches = 0
        r = _checked(lambda: dt.cholesky(dm, uplo=uplo))
        out[uplo] = {**r, "unchecked_seconds": unchecked_s, "potrf_tile": potrf_tile.launches,
                     "ksub_matmul_masked": ksub_matmul_masked.launches}
    for name, plant in (("extra_allreduce", _plant_extra_allreduce),
                        ("skipped_bcast", _plant_skipped_bcast),
                        ("p2p_epoch", _plant_p2p_epoch)):
        dm = dt.DistMatrix.from_global(a, nb, grid)
        out[name] = _checked(lambda: plant(dm, grid))
    real, debug.TIMEOUT_S = debug.TIMEOUT_S, STALL_TIMEOUT
    try:
        out["stall"] = _checked(lambda: _plant_stall(dm, grid))
    finally:
        debug.TIMEOUT_S = real
    return out


def _require_checked(runs, what: str) -> None:
    """A checked run (one entry a rank, in rank order) found nothing, with
    the same number of group collectives on every rank (send/receives may
    differ: the diagonal ranks of a square-grid transpose post none)."""
    for rank, r in enumerate(runs):
        require(r["findings"] == [], f"{what}: rank {rank} findings {r['findings']}")
    require(len({r["group"] for r in runs}) == 1 and runs[0]["group"] > 0,
            f"{what}: group collectives a rank {[r['group'] for r in runs]}")


def _grid_rank(n, nb, grid, device) -> dict:
    """One rank of phase_dist_grid, in a process of its own: cholesky L and
    U on the 2x2 grid, cholesky_info on a planted pivot, the distributed
    miniapp, and cholesky under the collective-schedule checker beside its
    planted divergences (``_checks_and_plants``); rank 0 then holds the gathered factors against the 1x1 grid's
    on the same card."""
    a = gen.random_hermitian_positive_definite(
        torch.Generator(device=device).manual_seed(GRID_SEED), n, torch.float32)
    out = {"rank": grid.rank, "coords": grid.coords}
    gathered = {}
    for uplo in ("L", "U"):
        dm = dt.DistMatrix.from_global(a, nb, grid)
        potrf_tile.launches = ksub_matmul_masked.launches = 0
        t, f = _timed_cholesky(dm, uplo)
        out[uplo] = {"seconds": t, "potrf_tile": potrf_tile.launches,
                     "ksub_matmul_masked": ksub_matmul_masked.launches}
        gathered[uplo] = dt.DistMatrix(f, dm.dist, grid).to_global()
        del dm, f
    bad = a.clone()
    bad[GRID_BAD, GRID_BAD] = -1.0
    out["info"] = int(dt.cholesky_info(dt.DistMatrix.from_global(bad, nb, grid))[1])
    del bad
    out["miniapp"] = _miniapp(GRID_MINIAPP)
    out["checked"] = _checks_and_plants(a, nb, grid)
    if grid.rank == 0:
        for uplo, tri in (("L", torch.tril), ("U", torch.triu)):
            g = gathered[uplo]
            ref = dt.cholesky(dt.DistMatrix.from_global(a, nb, dt.Grid((1, 1))), uplo=uplo).data
            out[uplo]["other_kept"] = _other_kept(g, a, uplo)
            got, want = tri(g), tri(ref)
            out[uplo]["deviation"] = factor_deviation(got, want, ROUTE_C)
            j = (n - 1, 0) if uplo == "L" else (0, n - 1)
            got[j] += 1e-3 * max(1.0, float(want[j].abs()))
            out[uplo]["planted_deviation"] = factor_deviation(got, want, ROUTE_C)
    return out


def _dist_grid_checks(checked) -> None:
    """phase_dist_grid's checked runs and plants, one entry a rank in rank
    order."""
    for uplo in "LU":
        _require_checked([r[uplo] for r in checked], f"checked grid cholesky {uplo}")
        require(all(r[uplo]["ksub_matmul_masked"] > 0 for r in checked) and
                sum(r[uplo]["potrf_tile"] for r in checked) > 0,
                f"checked grid cholesky {uplo}: K1/K6 launches {[r[uplo] for r in checked]}")
    for name, kind in PLANT_FINDINGS.items():
        for rank, r in enumerate(checked):
            f = r[name]["findings"]
            require(len(f) == 1 and f[0].startswith(kind + ":") and
                    f == checked[0][name]["findings"],
                    f"planted {name}: rank {rank} found {f}, not one {kind}")
            require(r[name]["seconds"] < PLANT_SECONDS,
                    f"planted {name}: rank {rank} took {r[name]['seconds']} s")
    stall = checked[0]["stall"]["findings"]
    for rank, r in enumerate(checked):
        require(r["stall"]["findings"] == stall and len(stall) == 3 and
                all(f.startswith("stalled:") and "for ranks [0]" in f for f in stall) and
                sorted(int(f.split()[2]) for f in stall) == [1, 2, 3],
                f"planted stall: rank {rank} found {r['stall']['findings']}, not one "
                "stalled for ranks [0] from each of ranks 1, 2, 3")
        require(r["stall"]["seconds"] < STALL_S + 2 * STALL_TIMEOUT,
                f"planted stall: rank {rank} took {r['stall']['seconds']} s")
    emit("collective_check", where="dist_grid", n=N_GRID, nb=NB_MAIN, grid=[2, 2],
         checked={u: [{k: r[u][k] for k in ("seconds", "unchecked_seconds", "ops", "group", "p2p",
                                             "potrf_tile", "ksub_matmul_masked")}
                      for r in checked] for u in "LU"},
         plants={name: {"finding": checked[0][name]["findings"][0],
                        "seconds": [r[name]["seconds"] for r in checked]}
                 for name in PLANT_FINDINGS},
         stall={"timeout_s": STALL_TIMEOUT, "late_s": STALL_S, "findings": stall,
                "seconds": [r["stall"]["seconds"] for r in checked]})


def phase_dist_grid() -> None:
    """``cholesky`` on a 2x2 grid of four gloo ranks that share the card
    (NCCL takes one rank per card), at n = 8192, nb = 512, L and U: K6
    launched on every rank, the gathered factor within ROUTE_C of the 1x1
    grid's entry by entry (shown one entry moved by 1e-3), the other
    triangle bit-equal to the input, ``cholesky_info`` on a planted pivot,
    and the distributed miniapp with ``--check``, all under ``spawn_grid``;
    then L and U again unchecked and under the collective-schedule checker
    (no finding, 48 group collectives a rank), the checker's three
    planted divergences and its planted stall (``collective_check``)."""
    t0 = time.perf_counter()
    outs = spawn_grid(functools.partial(_grid_rank, N_GRID, NB_MAIN), (2, 2), backend="gloo",
                      device="cuda", timeout=900)
    seconds = time.perf_counter() - t0
    tile = GRID_BAD // NB_MAIN
    r0 = outs[0]
    for r in outs:
        for uplo in "LU":
            require(r[uplo]["ksub_matmul_masked"] > 0, f"grid rank {r['rank']} {uplo}: "
                    f"no K6 launch ({r[uplo]})")
        require(tile * NB_MAIN < r["info"] <= (tile + 1) * NB_MAIN and r["info"] == r0["info"],
                f"grid cholesky_info {r['info']} outside tile {tile} or differs between ranks")
    for uplo in "LU":
        require(r0[uplo]["other_kept"], f"grid {uplo}: the other triangle changed")
        require(r0[uplo]["deviation"] <= 1.0 < r0[uplo]["planted_deviation"],
                f"grid {uplo}: deviation from the 1x1 factor {r0[uplo]}")
    require("check: PASSED" in r0["miniapp"], f"distributed miniapp: {r0['miniapp']}")
    require(all(r["miniapp"] == "" for r in outs[1:]), "only rank 0 of the miniapp prints")
    _dist_grid_checks([r.pop("checked") for r in outs])
    emit("dist_grid", n=N_GRID, nb=NB_MAIN, grid=[2, 2], backend="gloo", ranks_on_one_card=4,
         seconds=seconds, info=r0["info"], bad_index=GRID_BAD,
         ranks=[{k: v for k, v in r.items() if k != "miniapp"} for r in outs],
         miniapp=r0["miniapp"].strip().splitlines())


# ---------------------------------------------------------------------------
# The rest of the local API (trsm, trmm, hegst, herk) at full size, and the
# generalized eigensolver at eigh_main's configuration


def _sync_s(fn):
    """(seconds, result) of fn() between two synchronizations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _timed(fn, runs: int):
    """One warm-up, then ``runs`` timed calls: (seconds, the last result)."""
    fn()
    secs, out = [], None
    for _ in range(runs):
        out = None
        t, out = _sync_s(fn)
        secs.append(t)
    return secs, out


def _chunked_max(err_chunk, ncols: int) -> float:
    """max over 4096-column chunks of err_chunk(c0, c1) (each a max of
    |...|), so that no f64 temporary is larger than n x 4096."""
    return max(err_chunk(c, min(c + 4096, ncols)) for c in range(0, ncols, 4096))


@contextlib.contextmanager
def _nth_call(mod, name, k: int, fault):
    """Planted fault: call number ``k`` of ``mod.name`` returns ``fault`` of
    its arguments in place of the real result."""
    calls = [0]

    def wrap(real):
        def call(*args, **kw):
            calls[0] += 1
            return fault(*args, **kw) if calls[0] - 1 == k else real(*args, **kw)
        return call

    with _patched(mod, name, wrap):
        yield


def _skip_leaf_solve(a, b, **kw):
    return b.clone()


def _skip_leaf_multiply(a, lower, unit=False):
    return torch.eye(a.shape[0], dtype=a.dtype, device=a.device)


def _poisoned_triangular(g, n, lower, unit):
    """random_triangular with 99 in the triangle no call may read (and 5 on
    a unit diagonal, which is not read either); and the f64 triangle the
    calls compute with."""
    a = gen.random_triangular(g, n, torch.float32, lower=lower, unit=unit)
    a64 = a.double()
    junk = torch.full_like(a, 99.0)
    a += torch.triu(junk, 1) if lower else torch.tril(junk, -1)
    if unit:
        a.diagonal().fill_(5.0)
    return a, a64


def _op64(a64, trans):
    return {"N": a64, "T": a64.T, "C": a64.mH}[trans]


def _blas_sweep() -> dict:
    """Every side/uplo/trans/diag case of trsm and trmm at (m, n) =
    BLAS_SWEEP against f64 on the card, in the units of the gates."""
    m, n = BLAS_SWEEP
    g = torch.Generator(device=DEV).manual_seed(21)
    worst = {"trsm": 0.0, "trmm": 0.0}
    cases = {}
    for side in "LR":
        for uplo in "LU":
            for trans in "NTC":
                for diag in "NU":
                    na = m if side == "L" else n
                    a, a64 = _poisoned_triangular(g, na, uplo == "L", diag == "U")
                    b = gen.random_general(g, (m, n), torch.float32)
                    b64 = b.double()
                    kw = dict(side=side, uplo=uplo, trans=trans, diag=diag, nb=NB_MAIN)
                    opa = _op64(a64, trans)
                    x = dt.trsm(a, b, **kw).double()
                    lhs = opa @ x if side == "L" else x @ opa
                    r_s = float((lhs - b64).abs().max()) / (m * EPS32 * float(b64.abs().max()))
                    y64 = opa @ b64 if side == "L" else b64 @ opa
                    y = dt.trmm(a, b, **kw).double()
                    r_m = float((y - y64).abs().max()) / (m * EPS32 * float(y64.abs().max()))
                    cases[side + uplo + trans + diag] = [r_s, r_m]
                    worst["trsm"] = max(worst["trsm"], r_s)
                    worst["trmm"] = max(worst["trmm"], r_m)
    for k, v in worst.items():
        require(v <= BLAS_BOUND, f"{k} sweep at {BLAS_SWEEP}: {v} > {BLAS_BOUND} ({cases})")
    return {"m": m, "n": n, "worst": worst, "cases": cases}


def _trsm_trmm_main() -> dict:
    """trsm and trmm side L, uplo L, trans N at A 32768 x 32768, B 32768 x
    16384, and trsm side R once, each beside its library yardstick; the
    gates beside a planted fault (one leaf solve or leaf multiply skipped)."""
    m, n = N_BLAS, NRHS_BLAS
    g = torch.Generator(device=DEV).manual_seed(22)
    a = gen.random_triangular(g, m, torch.float32, lower=True)
    b = gen.random_general(g, (m, n), torch.float32)
    bmax = float(b.abs().max())
    flops = m * m * n
    out = {"m": m, "n": n, "flops": flops}
    a64 = a.double()
    kw = dict(side="L", uplo="L", trans="N", nb=NB_MAIN)

    def trsm_reading(x):
        return _chunked_max(lambda c0, c1: float(
            (a64 @ x[:, c0:c1].double()).sub_(b[:, c0:c1].double()).abs_().max()), n) / (
            m * EPS32 * bmax)

    secs, x = _timed(lambda: dt.trsm(a, b, **kw), 2)
    out["trsm"] = {"seconds": secs, "tflops": flops / min(secs) / 1e12,
                   "reading": trsm_reading(x)}
    del x
    with _nth_call(blocked, "trsm_leaf", m // NB_MAIN // 2, _skip_leaf_solve):
        out["trsm"]["planted_reading"] = trsm_reading(dt.trsm(a, b, **kw))
    lib, x = _timed(lambda: torch.linalg.solve_triangular(a, b, upper=False), 1)
    out["trsm"].update(library_seconds=lib, library_tflops=flops / lib[0] / 1e12,
                       library="torch.linalg.solve_triangular", library_reading=trsm_reading(x))
    del x

    def trmm_reading(y):
        ymax = [0.0]      # max|Y64|, gathered chunk by chunk

        def chunk(c0, c1):
            ref = a64 @ b[:, c0:c1].double()
            ymax[0] = max(ymax[0], float(ref.abs().max()))
            return float(ref.sub_(y[:, c0:c1].double()).abs_().max())

        err = _chunked_max(chunk, n)
        return err / (m * EPS32 * ymax[0])

    secs, y = _timed(lambda: dt.trmm(a, b, **kw), 2)
    out["trmm"] = {"seconds": secs, "tflops": flops / min(secs) / 1e12,
                   "reading": trmm_reading(y)}
    del y
    with _nth_call(blocked, "take_tri", m // NB_MAIN // 2, _skip_leaf_multiply):
        out["trmm"]["planted_reading"] = trmm_reading(dt.trmm(a, b, **kw))
    lib, y = _timed(lambda: torch.tril(a) @ b, 1)
    out["trmm"].update(library_seconds=lib, library_tflops=flops / lib[0] / 1e12,
                       library="torch.tril(A) @ B", library_reading=trmm_reading(y))
    del y
    # the right side once: X A = B with B 16384 x 32768 (column views)
    bt = b.T.contiguous()
    del b
    t_r, x = _timed(lambda: dt.trsm(a, bt, side="R", uplo="L", trans="N", nb=NB_MAIN), 1)
    reading_r = _chunked_max(lambda r0, r1: float(
        (x[r0:r1].double() @ a64).sub_(bt[r0:r1].double()).abs_().max()), n) / (
        m * EPS32 * bmax)
    del x
    lib_r, _ = _timed(lambda: torch.linalg.solve_triangular(a, bt, upper=False, left=False), 1)
    out["trsm_right"] = {"seconds": t_r, "tflops": flops / t_r[0] / 1e12, "reading": reading_r,
                         "library_seconds": lib_r, "library_tflops": flops / lib_r[0] / 1e12}
    del a, a64, bt
    torch.cuda.empty_cache()
    for k in ("trsm", "trmm"):
        r = out[k]
        require(r["reading"] <= BLAS_BOUND < r["planted_reading"],
                f"{k} n={m}: reading {r['reading']}, planted {r['planted_reading']}, "
                f"bound {BLAS_BOUND}")
        require(r["reading"] <= MINIAPP_BLAS_BOUND, f"{k} n={m}: the miniapp's gate")
    require(out["trsm_right"]["reading"] <= BLAS_BOUND, f"trsm R n={m}: {out['trsm_right']}")
    return out


def _hegst_reading(r, a, l) -> dict:
    """hegst's R = L^-1 A L^-H on rows [0, s) and columns [0, s), s =
    HEGST_SLICE, against the same slices formed in f64 (together they
    meet every leaf of both solves): in units of n eps32 max|R64|, and in
    the miniapp's units n eps32 max(1, max|R64|) (R is O(max|A| / n) here,
    so the miniapp's clamp to 1 takes its scale)."""
    n, s = a.shape[0], HEGST_SLICE
    l64 = l.double()
    rows = torch.linalg.solve_triangular(l64[:s, :s], torch.linalg.solve_triangular(
        l64, a[:, :s].double(), upper=False).mH, upper=False)
    cols = torch.linalg.solve_triangular(l64, torch.linalg.solve_triangular(
        l64[:s, :s], a[:s].double(), upper=False).mH, upper=False)
    del l64
    scale = max(float(rows.abs().max()), float(cols.abs().max()))
    err = max(float((r[:s].double() - rows).abs().max()),
              float((r[:, :s].double() - cols).abs().max()))
    return {"reading": err / (n * EPS32 * scale),
            "miniapp_reading": err / (n * EPS32 * max(1.0, scale))}


def _hegst_main() -> dict:
    """hegst (uplo L) of a 32768 hermitian A against the K1 factor of a
    32768 SPD B; two library solves beside it; the gate beside a planted
    fault (one leaf solve of the first solve skipped)."""
    n = N_BLAS
    g = torch.Generator(device=DEV).manual_seed(23)
    a = gen.random_hermitian(g, n, torch.float32)
    b = gen.random_hermitian_positive_definite(g, n, torch.float32)
    potrf_tile.launches = 0
    t_l, l = _sync_s(lambda: dt.potrf(b, uplo="L", nb=NB_MAIN))
    k1 = potrf_tile.launches
    del b
    flops = 2 * n**3            # two full triangular solves with n right-hand sides
    secs, r = _timed(lambda: dt.hegst(a, l, nb=NB_MAIN), 2)
    out = {"n": n, "potrf_seconds": t_l, "potrf_k1_launches": k1, "seconds": secs,
           "flops": flops, "tflops": flops / min(secs) / 1e12, **_hegst_reading(r, a, l)}
    del r
    torch.cuda.empty_cache()
    with _nth_call(blocked, "trsm_leaf", n // NB_MAIN // 2, _skip_leaf_solve):
        planted = _hegst_reading(dt.hegst(a, l, nb=NB_MAIN), a, l)
    out["planted_reading"] = planted["reading"]
    torch.cuda.empty_cache()

    def library():
        y = torch.linalg.solve_triangular(l, a, upper=False)
        return torch.linalg.solve_triangular(l, y.mH, upper=False)

    lib, r = _timed(library, 1)
    out.update(library_seconds=lib, library_tflops=flops / lib[0] / 1e12,
               library="two torch.linalg.solve_triangular",
               library_reading=_hegst_reading(r, a, l)["reading"])
    del a, l, r
    torch.cuda.empty_cache()
    require(k1 > 0, "hegst's potrf launched K1")
    require(out["reading"] <= BLAS_BOUND < out["planted_reading"],
            f"hegst n={n}: reading {out['reading']}, planted {out['planted_reading']}")
    require(out["miniapp_reading"] <= MINIAPP_HEGST_BOUND, f"hegst n={n}: the miniapp's gate")
    return out


def _herk_main() -> dict:
    """herk U/C with alpha -1, beta 1 at n = k = 16384 (nb = 512) through K2,
    beside the same call on the plain route (potrf_trailing_kernel="torch").
    K2 writes the upper triangle's off-diagonal blocks: those are held to
    f64 with phase_k2's bound (the operands are K2's random inputs), beside
    a planted fault (K2 cut to one TF32 term). The diagonal 512-blocks are
    the leaves' products, the same on both routes: bit-equal between them
    and held per entry to f64 within k eps32 (|A|^T |A| + |C|), the
    forward-error bound of a length-k dot product (their Gram sums are all
    positive, so K2's bound does not apply there). The lower triangle stays
    C's, bit for bit."""
    n = k = N_HERK
    nb = NB_MAIN
    g = torch.Generator(device=DEV).manual_seed(24)
    a = gen.random_general(g, (k, n), torch.float32)
    c = gen.random_hermitian(g, n, torch.float32)
    want = c.double().addmm_(a.double().T, a.double(), alpha=-1)
    bound = EPS32 * (2 * k * float(a.abs().max()) ** 2 + float(c.abs().max()))
    blk = torch.arange(n, device=DEV) // nb
    off = (blk[:, None] < blk[None, :])          # the off-diagonal blocks K2 writes
    kw = dict(uplo="U", trans="C", alpha=-1.0, beta=1.0)
    out = {"n": n, "k": k, "nb": nb, "flops": n * n * k, "k2_bound": bound}

    def off_reading(f):
        require(torch.equal(torch.tril(f, -1), torch.tril(c, -1)),
                "herk wrote the lower triangle")
        return float(torch.where(off, (f.double() - want).abs(), 0).max()) / bound

    def diag_reading(f):
        worst = 0.0
        for i in range(0, n, nb):
            s = slice(i, i + nb)
            scale = a[:, s].double().abs()
            scale = scale.T @ scale + c[s, s].double().abs()
            err = (f[s, s].double() - want[s, s]).abs() / (k * EPS32 * scale)
            worst = max(worst, float(torch.triu(err).max()))
        return worst

    diag = {}
    dt.set_tune_parameters(leaf_block_size=nb)
    try:
        for route in ("kernel", "torch"):
            dt.set_tune_parameters(potrf_trailing_kernel=route)
            ksub_matmul.launches = 0
            secs, f = _timed(lambda: dt.herk(a, c, **kw), 2)
            diag[route] = torch.cat([torch.triu(f[i:i + nb, i:i + nb]) for i in range(0, n, nb)])
            out[route] = {"seconds": secs, "tflops": n * n * k / min(secs) / 1e12,
                          "ksub_matmul_launches_per_call": ksub_matmul.launches // 3,
                          "reading": off_reading(f), "diagonal_block_reading": diag_reading(f)}
            del f
        dt.set_tune_parameters(potrf_trailing_kernel="kernel")

        def one_term(real):
            return lambda c_, x, y, x_k_major=True: c_.copy_(
                ksub_matmul_split_ref(c_, x, y, x_k_major, terms=1))

        with _patched(blocked, "ksub_matmul", one_term):
            out["planted_one_tf32_term_reading"] = off_reading(dt.herk(a, c, **kw))
    finally:
        dt.reset_tune_parameters()
    out["diagonal_blocks_bit_equal"] = torch.equal(diag["kernel"], diag["torch"])
    require(out["kernel"]["ksub_matmul_launches_per_call"] > 0, "herk U/C launched K2")
    require(out["torch"]["ksub_matmul_launches_per_call"] == 0, "the plain herk launched K2")
    require(out["diagonal_blocks_bit_equal"], "herk's diagonal blocks differ between routes")
    for route in ("kernel", "torch"):
        r = out[route]
        require(r["reading"] <= 1.0 and r["diagonal_block_reading"] <= 1.0, f"herk {route}: {r}")
    require(out["planted_one_tf32_term_reading"] > 1.0, "herk's bound passes one TF32 term")
    del a, c, want, off, diag
    torch.cuda.empty_cache()
    return out


def phase_blas_main() -> None:
    """trsm, trmm, hegst and herk in f32 at the repo's headline size
    (nb = 512), each beside a library yardstick and its gate beside a
    planted fault; every trsm/trmm case at n = 2048 against f64."""
    torch.cuda.empty_cache()
    parts, seconds = {}, {}
    for name, fn in (("sweep", _blas_sweep), ("trsm_trmm", _trsm_trmm_main),
                     ("hegst", _hegst_main), ("herk", _herk_main)):
        t0 = time.perf_counter()
        parts[name] = fn()
        seconds[name] = time.perf_counter() - t0
    KERNELS["potrf_tile"].setdefault("launches_on_paths", {})["hegst's potrf n=32768"] = \
        parts["hegst"]["potrf_k1_launches"]
    KERNELS["ksub_matmul"].setdefault("launches_on_paths", {})["herk U/C n=k=16384"] = \
        parts["herk"]["kernel"]["ksub_matmul_launches_per_call"]
    emit("blas_main", dtype="float32", nb=NB_MAIN, bound=BLAS_BOUND,
         units={"trsm": "max|op(A)X - B| / (m eps32 max|B|)",
                "trmm": "max|Y - Y64| / (m eps32 max|Y64|)",
                "hegst": "max|R - R64| / (n eps32 max|R64|) on R[:4096, :], R[:, :4096] "
                          "(miniapp_reading: max(1, max|R64|))",
                "herk": "max|C - C64| on the off-diagonal blocks / (eps32 (2k max|A|^2 + "
                         "max|C|)); diagonal blocks: max |C - C64| / (k eps32 (|A|^T|A| "
                         "+ |C|)) per entry"},
         miniapp_bounds={"trsm": MINIAPP_BLAS_BOUND, "trmm": MINIAPP_BLAS_BOUND,
                         "hegst": MINIAPP_HEGST_BOUND},
         part_seconds=seconds, **parts)


def _gen_readings(a64, b64, w, x) -> dict:
    """eigh_gen's gates in f64 on the card: residual max|A X - B X diag(w)|
    in units of n eps32 max(1, max|A|), max|X^H B X - I| in units of
    n eps32; and the miniapp's gate (2000 in these units) on them."""
    n = a64.shape[0]
    x64 = x.double()
    unit = n * EPS32
    res = float((a64 @ x64 - (b64 @ x64) * w.double()[None, :]).abs().max()) / (
        unit * max(1.0, float(a64.abs().max())))
    borth = float((x64.mT @ b64 @ x64 - torch.eye(n, dtype=torch.float64, device=DEV))
                  .abs().max()) / unit
    return {"res": res, "borth": borth, "miniapp_gate": res <= 2000 and borth <= 2000}


def _eigh_gen_stages(a, b, band: int):
    """dt.eigh_gen's stages (uplo L, not factorized), as driver.eigh_gen and
    gen_to_std run them, with a synchronization after each: (w, x, seconds
    per stage, the factor)."""
    nb = dt.get_tune_parameters().leaf_block_size
    n = a.shape[0]
    secs = {}

    def lap(name, fn):
        t, out = _sync_s(fn)
        secs[name] = t
        return out

    l = lap("potrf_k1", lambda: dt.potrf(b, uplo="L", nb=nb))
    lp = _tri_operand(l, nb, identity=True)

    def first():
        y = hermitian_from_tri_(_pad_zero(a, nb), True)
        return blocked.trsm(y, lp, side="L", lower=True, trans="N", unit=False, nb=nb)

    y = lap("hegst_solve1", first)
    y = lap("hegst_solve2", lambda: blocked.trsm(
        ct(y).clone(memory_format=torch.contiguous_format), lp, side="L", lower=True,
        trans="N", unit=False, nb=nb))
    w, z = lap("eigh_k3", lambda: dt.eigh(y[:n, :n], uplo="L", band=band))
    x = lap("back_solve", lambda: dt.trsm(l, z, side="L", uplo="L", trans="C", nb=nb))
    return w, x, secs, l


def _library_gen(a, b):
    """The library route: cholesky, two solve_triangular, eigh, one
    solve_triangular; seconds per stage."""
    secs = {}

    def lap(name, fn):
        t, out = _sync_s(fn)
        secs[name] = t
        return out

    l = lap("cholesky", lambda: torch.linalg.cholesky(b))
    y = lap("solve1", lambda: torch.linalg.solve_triangular(l, a, upper=False))
    y = lap("solve2", lambda: torch.linalg.solve_triangular(l, y.mH, upper=False))
    w, z = lap("eigh", lambda: torch.linalg.eigh(y))
    x = lap("back_solve", lambda: torch.linalg.solve_triangular(l.mH, z, upper=True))
    return w, x, secs


def _local_miniapps() -> dict:
    """The four new miniapps on the card with --check, and the K1 and K3
    launches each made."""
    runs = {}
    for mod, argv, k1, k3 in (
            (miniapp_triangular_solver, ["-n", "1024", "-b", "512"], False, False),
            (miniapp_triangular_multiplication, ["-n", "1024", "-b", "512"], False, False),
            (miniapp_gen_to_std, ["-n", "1024", "-b", "512"], True, False),
            (miniapp_gen_eigensolver, ["-n", "512"], True, True)):
        name = mod.__name__.rsplit(".", 1)[1]
        _counters_reset()
        out = _miniapp(argv + ["--check", "--nruns", "1"], mod)
        counts = _counters()
        require("check: PASSED" in out, f"{name}: {out}")
        require((counts["potrf_tile"] > 0) == k1 and
                (counts["band_to_tridiag_strips"] > 0) == k3, f"{name}: launches {counts}")
        runs[name] = {"lines": out.strip().splitlines(),
                      "k1_launches": counts["potrf_tile"],
                      "k3_launches": counts["band_to_tridiag_strips"]}
    return runs


def phase_eigh_gen_main() -> None:
    """eigh_gen at n = 8192 f32, band 128 (eigh_main's configuration), nb =
    512: a warm-up, two timed runs through the entry point (K1 and K3
    launches counted), a staged run timed by stage and held bit-equal to
    the entry point's, the library route beside it, the gates beside a
    planted fault (one column of B's factor scaled by 1.5), then the four
    new miniapps."""
    n, band = N_EIGH, B_EIGH
    torch.cuda.empty_cache()
    g = torch.Generator(device=DEV).manual_seed(25)
    a = gen.random_hermitian(g, n, torch.float32)
    b = gen.random_hermitian_positive_definite(g, n, torch.float32)
    a64, b64 = a.double(), b.double()
    dt.set_tune_parameters(leaf_block_size=NB_MAIN)
    try:
        dt.eigh_gen(a, b, band=band)
        secs, ws = [], []
        for _ in range(2):
            _counters_reset()
            t, (w, x) = _sync_s(lambda: dt.eigh_gen(a, b, band=band))
            counts = _counters()
            secs.append(t)
            ws.append(w)
        require(counts["potrf_tile"] > 0 and counts["band_to_tridiag_strips"] > 0,
                f"eigh_gen launched K1 and K3: {counts}")
        readings = _gen_readings(a64, b64, w, x)
        w_s, x_s, stages, l = _eigh_gen_stages(a, b, band)
        same = {"w_timed_runs": torch.equal(*ws), "w_staged": torch.equal(w_s, w),
                "x_staged": torch.equal(x_s, x)}
        require(same["w_staged"], f"the staged eigh_gen computes what dt.eigh_gen does ({same})")
        del x, x_s, ws
        # planted fault: column n/2 of B's factor scaled by 1.5
        l_bad = l.clone()
        l_bad[:, n // 2] *= 1.5
        w_bad, x_bad = dt.eigh_gen(a, l_bad, factorized=True, band=band)
        planted = _gen_readings(a64, b64, w_bad, x_bad)
        del l, l_bad, w_bad, x_bad
    finally:
        dt.reset_tune_parameters()
    require(readings["miniapp_gate"], f"eigh_gen n={n}: the miniapp's gates ({readings})")
    for k, bound in GEN_BOUNDS.items():
        require(readings[k] <= bound < planted[k],
                f"eigh_gen {k}: reading {readings[k]}, planted {planted[k]}, bound {bound}")
    _library_gen(a, b)
    w_l, x_l, lib_stages = _library_gen(a, b)
    lib_readings = _gen_readings(a64, b64, w_l, x_l)
    del a, b, a64, b64, w_l, x_l
    torch.cuda.empty_cache()
    KERNELS["potrf_tile"].setdefault("launches_on_paths", {})["eigh_gen n=8192"] = \
        counts["potrf_tile"]
    KERNELS["band_to_tridiag_strips"].setdefault("launches_on_paths", {})["eigh_gen n=8192"] = \
        counts["band_to_tridiag_strips"]
    miniapps = _local_miniapps()
    emit("eigh_gen_main", n=n, band=band, nb=NB_MAIN, dtype="float32", seconds=secs,
         stage_seconds=stages, launches=counts, readings=readings, bounds=GEN_BOUNDS,
         units={"res": "max|A X - B X diag(w)| / (n eps32 max(1, max|A|))",
                "borth": "max|X^T B X - I| / (n eps32)"},
         planted_fault_readings=planted, bit_equal=same, library_stage_seconds=lib_stages,
         library_seconds=sum(lib_stages.values()), library_readings=lib_readings,
         library="torch.linalg.cholesky + 2 solve_triangular + torch.linalg.eigh + "
                 "solve_triangular, f32",
         miniapps=miniapps)


# ---------------------------------------------------------------------------
# The stage miniapps and kernel_runner; the distributed BLAS-3 on a 1x1 grid
# at full width and on grids of four gloo ranks sharing the card


def _launch_path(kernel: str, path: str, count: int) -> None:
    KERNELS[kernel].setdefault("launches_on_paths", {})[path] = count


def _kernel_runner_checks() -> dict:
    """kernel_runner's potrf (K1, one launch a tile) and ksub (K2) on the
    miniapp's own inputs at nb = 512, count 64, against their plain
    versions at K1's and K2's bounds, each beside a planted fault (one
    tile's factor with a slab update skipped; K2's split cut to one TF32
    term)."""
    nb, count = NB_MAIN, STAGE_COUNT
    table = kernel_runner.kernels(nb, count, torch.float32, DEV)
    fn, args, _ = table["potrf"]
    potrf_tile.launches = 0
    got = fn(*args)
    launches = potrf_tile.launches
    spd = args[0]
    dev = max(factor_deviation(got[i], potrf_tile_ref(spd[i]), K1_C) for i in range(count))
    bad = got.clone()
    bad[count // 2] = _planted(spd[count // 2], False, nb // 32 - 2)
    planted = max(factor_deviation(bad[i], potrf_tile_ref(spd[i]), K1_C) for i in range(count))
    require(launches == count, f"kernel_runner potrf: {launches} K1 launches for {count} tiles")
    require(dev <= 1.0 < planted, f"kernel_runner potrf: deviation {dev}, planted {planted}")
    fn, (c, x, y), _ = table["ksub"]
    ksub_matmul.launches = 0
    out = fn(c, x, y)
    k2 = ksub_matmul.launches
    want = ksub_matmul_ref(c.double(), x.double(), y.double())
    bound = EPS32 * (2 * x.shape[0] * float(x.abs().max()) * float(y.abs().max())
                     + float(c.abs().max()))
    err = float((out.double() - want).abs().max())
    planted_k2 = float((ksub_matmul_split_ref(c, x, y, terms=1).double() - want).abs().max())
    require(k2 == 1, f"kernel_runner ksub: {k2} K2 launches")
    require(err <= bound < planted_k2, f"kernel_runner ksub: err {err}, planted {planted_k2}, "
            f"bound {bound}")
    return {"potrf": {"k1_launches": launches, "deviation": dev, "planted_deviation": planted,
                      "bound": 1.0},
            "ksub": {"k2_launches": k2, "max_abs_err": err, "bound": bound,
                     "planted_one_term_err": planted_k2}}


def phase_stage_miniapps() -> None:
    """The five stage miniapps with --check at eigh_main's configuration (n
    = 8192 f32, band 128, a warm-up and one timed run), K3's launches
    counted on each (band_to_tridiag: one a run; bt_band_to_tridiag: one
    for its record); then kernel_runner at nb = 512: potrf (64 K1 launches
    a run), ksub (one K2 launch), trsm and gemm, with the potrf batch and
    the ksub output held to K1's and K2's plain versions."""
    runs = {}
    common = ["-n", str(N_EIGH), "--band-size", str(B_EIGH), "--check", "--nruns", "1",
              "--nwarmups", "1"]
    for mod, k3 in ((miniapp_reduction_to_band, 0), (miniapp_band_to_tridiag, 2),
                    (miniapp_tridiag_solver, 0), (miniapp_bt_band_to_tridiag, 1),
                    (miniapp_bt_reduction_to_band, 0)):
        name = mod.__name__.rsplit(".", 1)[1]
        _counters_reset()
        t0 = time.perf_counter()
        out = _miniapp(common, mod)
        counts = _counters()
        require("check: PASSED" in out, f"{name}: {out}")
        require(counts["band_to_tridiag_strips"] == k3, f"{name}: K3 launches {counts}")
        runs[name] = {"lines": out.strip().splitlines(), "seconds": time.perf_counter() - t0,
                      "k3_launches": counts["band_to_tridiag_strips"]}
        torch.cuda.empty_cache()
    _launch_path("band_to_tridiag_strips", "miniapp_band_to_tridiag n=8192 (warm-up + run)",
                 runs["miniapp_band_to_tridiag"]["k3_launches"])
    _launch_path("band_to_tridiag_strips", "miniapp_bt_band_to_tridiag n=8192",
                 runs["miniapp_bt_band_to_tridiag"]["k3_launches"])
    kr = {}
    for kernel in ("potrf", "ksub", "trsm", "gemm"):
        _counters_reset()
        out = _miniapp(["--kernel", kernel, "-b", str(NB_MAIN), "--count", str(STAGE_COUNT),
                        "--nruns", "2", "--nwarmups", "1"], kernel_runner)
        counts = _counters()
        lines = out.strip().splitlines()
        require(len(lines) == 2 and all("us/tile" in l for l in lines), f"kernel_runner: {out}")
        kr[kernel] = {"lines": lines, "us_per_tile": [float(l.split(": ")[1].split(" us")[0])
                                                       for l in lines],
                      "k1_launches": counts["potrf_tile"], "k2_launches": counts["ksub_matmul"]}
    require(kr["potrf"]["k1_launches"] == 3 * STAGE_COUNT and kr["ksub"]["k2_launches"] == 3,
            f"kernel_runner launches: {kr}")
    checks = _kernel_runner_checks()
    _launch_path("potrf_tile", f"kernel_runner potrf x{STAGE_COUNT} (a run)",
                 checks["potrf"]["k1_launches"])
    _launch_path("ksub_matmul", "kernel_runner ksub (a run)", checks["ksub"]["k2_launches"])
    emit("stage_miniapps", n=N_EIGH, band=B_EIGH, dtype="float32", miniapps=runs,
         kernel_runner={"nb": NB_MAIN, "count": STAGE_COUNT, **kr}, kernel_checks=checks)


def _dm(x, pad=False, grid=None):
    return dt.DistMatrix.from_global(x, NB_MAIN, grid or dt.Grid((1, 1)), pad_identity=pad)


def _skip_panel(*args, **kw):
    """Planted fault for general._a_panel: this k panel contributes nothing."""
    return None


def _skip_tile_solve(b, a, **kw):
    """Planted fault for blocked.trsm: the diagonal-tile solve left out."""
    return b


def _to64(t: torch.Tensor) -> torch.Tensor:
    return t.to(_wide(t.dtype))


def _blocks(n: int):
    return [(i, min(i + 4096, n)) for i in range(0, n, 4096)]


def _tri_reading(a, x, b, side="L") -> float:
    """max|op(A) X - B| / (m eps32 max|B|) in f64 (complex128), by 4096 x
    4096 blocks of the product, so that no f64 copy of A is made."""
    m = a.shape[0]
    err = 0.0
    if side == "L":
        for c0, c1 in _blocks(x.shape[1]):
            xc = _to64(x[:, c0:c1])
            for r0, r1 in _blocks(m):
                err = max(err, float((_to64(a[r0:r1]) @ xc).sub_(_to64(b[r0:r1, c0:c1]))
                                     .abs().max()))
    else:
        for c0, c1 in _blocks(m):
            ac = _to64(a[:, c0:c1])
            for r0, r1 in _blocks(x.shape[0]):
                err = max(err, float((_to64(x[r0:r1]) @ ac).sub_(_to64(b[r0:r1, c0:c1]))
                                     .abs().max()))
    return err / (m * EPS32 * float(b.abs().max()))


def _product_reading(a, b, y) -> float:
    """max|Y - A B| / (m eps32 max|A B|) in f64 (complex128), by 4096 x 4096
    blocks (the units of blas_main's trmm)."""
    err = ymax = 0.0
    for c0, c1 in _blocks(b.shape[1]):
        bc = _to64(b[:, c0:c1])
        for r0, r1 in _blocks(a.shape[0]):
            ref = _to64(a[r0:r1]) @ bc
            ymax = max(ymax, float(ref.abs().max()))
            err = max(err, float(ref.sub_(_to64(y[r0:r1, c0:c1])).abs().max()))
    return err / (a.shape[0] * EPS32 * ymax)


@contextlib.contextmanager
def _tf32_products():
    """Control: f32 products in one TF32 pass (cuBLAS's tensor-core route),
    which the port keeps off."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def _dist_and_local(name, dist_fn, local_fn, reading, planted_ctx, extra=None) -> dict:
    """A distributed call and its local counterpart, each a warm-up and two
    timed runs (in turns); the distributed result's reading, the local's,
    and the readings of the distributed call under a planted fault and
    with its f32 products in TF32. Only the first timed result of each is
    kept."""
    dist_fn()
    local_fn()
    secs = {"dist": [], "local": []}
    out = {}
    for which in ("dist", "local", "local", "dist"):
        t, r = _sync_s(dist_fn if which == "dist" else local_fn)
        secs[which].append(t)
        out.setdefault(which, r)
        del r
    res = {"seconds": secs, "dist_over_local": min(secs["dist"]) / min(secs["local"]),
           "reading": reading(out["dist"]), "local_reading": reading(out["local"])}
    del out
    torch.cuda.empty_cache()
    with planted_ctx():
        res["planted_reading"] = reading(dist_fn())
    torch.cuda.empty_cache()
    with _tf32_products():
        res["tf32_reading"] = reading(dist_fn())
    torch.cuda.empty_cache()
    require(res["reading"] <= BLAS_BOUND < res["planted_reading"],
            f"dist {name}: reading {res['reading']}, planted {res['planted_reading']}")
    require(res["reading"] <= TF32_GATE < res["tf32_reading"],
            f"dist {name}: reading {res['reading']}, with TF32 products {res['tf32_reading']}")
    if extra:
        res.update(extra)
    return res


def _conj_case() -> dict:
    """hermitian_multiplication L and generalized_to_standard_dist on a
    complex64 case at n = 2048 (1x1 grid, nb = 512), each against f64 in
    blas_main's units, beside the planted fault of a transpose that drops
    its conjugate (hemm's transposed stored row; gen_to_std's Y^H)."""
    n = 2048
    g = torch.Generator(device=DEV).manual_seed(31)
    a = gen.random_hermitian(g, n, torch.complex64)
    b = gen.random_general(g, (n, n // 2), torch.complex64)
    bs_ = gen.random_hermitian_positive_definite(g, n, torch.complex64)
    l = torch.linalg.cholesky(bs_)
    a64, l64 = a.to(torch.complex128), l.to(torch.complex128)
    stored = torch.tril(a) + torch.triu(torch.full_like(a, 7.0), 1)

    def no_conj(real):
        def f(*args, **kw):
            p = real(*args, **kw)
            return p.conj() if kw["trans"] == "C" else p
        return f

    def hemm_reading(y):
        return _product_reading(a64, b, y)

    def hemm():
        return dt.hermitian_multiplication(_dm(stored), _dm(b), uplo="L").data[:n, :n // 2]

    def g2s():
        return dt.generalized_to_standard_dist(_dm(a), _dm(l, True)).data[:n, :n]

    ref = torch.linalg.solve_triangular(l64, torch.linalg.solve_triangular(
        l64, a64, upper=False).mH, upper=False)

    def g2s_reading(r):
        return float((r.to(torch.complex128) - ref).abs().max()) / (
            n * EPS32 * float(ref.abs().max()))

    def transpose_no_conj(real):
        def f(self, conj=True):
            return real(self, conj=False)
        return f

    out = {"n": n, "dtype": "complex64", "hemm": {"reading": hemm_reading(hemm())},
           "gen_to_std": {"reading": g2s_reading(g2s())}}
    with _patched(general, "_op_panel", no_conj):
        out["hemm"]["planted_reading"] = hemm_reading(hemm())
    with _patched(dt.DistMatrix, "transpose", transpose_no_conj):
        out["gen_to_std"]["planted_reading"] = g2s_reading(g2s())
    for k in ("hemm", "gen_to_std"):
        r = out[k]
        require(r["reading"] <= BLAS_BOUND < r["planted_reading"],
                f"complex64 {k}: reading {r['reading']}, planted {r['planted_reading']}")
    return out


def phase_dist_blas_main() -> None:
    """The distributed BLAS-3 on a 1x1 grid at full width, f32, nb = 512:
    A 32768 x 32768, B 32768 x 16384 (blas_main's shapes).
    ``triangular_solver`` L/L/N and side R once, ``general``,
    ``hermitian`` (L) and ``triangular_multiplication`` (L/L), and
    ``generalized_to_standard_dist`` at n = 32768 (B's factor by potrf,
    through K1), each timed beside its local counterpart (trsm, gemm,
    hemm, trmm, hegst) in the same call and held to f64 in blas_main's
    units beside a planted fault (a skipped diagonal-tile solve or k
    panel) and, at TF32_GATE, beside its f32 products in TF32;
    ``max_norm`` G and ``permute`` of rows bit-equal to the local
    functions (beside a moved entry and two swapped indices); and the
    complex64 case at n = 2048 beside a transpose missing its conjugate.
    The device memory still allocated when it starts is recorded, before
    and after a garbage collection (what earlier phases left behind)."""
    held = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    m, n = N_BLAS, NRHS_BLAS
    g = torch.Generator(device=DEV).manual_seed(30)
    out = {"m": m, "n": n, "nb": NB_MAIN, "grid": [1, 1], "dtype": "float32",
           "allocated_gib_at_start": held / 2**30,
           "allocated_gib_after_gc": torch.cuda.memory_allocated() / 2**30}
    t0 = time.perf_counter()
    # at these orders the 1x1 shards are the global matrices (no padding):
    # the local calls take the shards themselves, so that A is held once
    da = _dm(gen.random_triangular(g, m, torch.float32, lower=True), True)
    db = _dm(gen.random_general(g, (m, n), torch.float32))
    a, b = da.data, db.data
    kw = dict(uplo="L", trans="N")
    out["triangular_solver"] = _dist_and_local(
        "triangular_solver", lambda: dt.triangular_solver(da, db, **kw).data,
        lambda: dt.trsm(a, b, nb=NB_MAIN, **kw), lambda x: _tri_reading(a, x, b),
        lambda: _nth_call(blocked, "trsm", m // NB_MAIN // 2, _skip_tile_solve),
        {"flops": m * m * n})
    dbt = _dm(b.T.contiguous())
    t_r, x = _timed(lambda: dt.triangular_solver(da, dbt, side="R", **kw).data, 1)
    reading_r = _tri_reading(a, x, dbt.data, side="R")
    del x
    t_l, x = _timed(lambda: dt.trsm(a, dbt.data, side="R", nb=NB_MAIN, **kw), 1)
    del x, dbt
    out["triangular_solver_right"] = {"seconds": t_r, "local_seconds": t_l,
                                      "reading": reading_r}
    require(reading_r <= TF32_GATE, f"dist trsm R: {out['triangular_solver_right']}")
    out["triangular_multiplication"] = _dist_and_local(
        "triangular_multiplication", lambda: dt.triangular_multiplication(da, db, uplo="L").data,
        lambda: dt.trmm(a, b, uplo="L", nb=NB_MAIN), lambda y: _product_reading(a, b, y),
        lambda: _nth_call(general, "_a_panel", m // NB_MAIN // 2, _skip_panel),
        {"flops": m * m * n})
    del a, da
    torch.cuda.empty_cache()
    # general and hermitian multiplication: A 32768^2 general / hermitian
    da = _dm(gen.random_hermitian(g, m, torch.float32))
    a = da.data
    out["general_multiplication"] = _dist_and_local(
        "general_multiplication", lambda: dt.general_multiplication(da, db).data,
        lambda: dt.gemm(a, b), lambda y: _product_reading(a, b, y),
        lambda: _nth_call(general, "_a_panel", m // NB_MAIN // 2, _skip_panel),
        {"flops": 2 * m * m * n})
    dstored = _dm(torch.tril(a))
    out["hermitian_multiplication"] = _dist_and_local(
        "hermitian_multiplication",
        lambda: dt.hermitian_multiplication(dstored, db, uplo="L").data,
        lambda: dt.hemm(a, b, uplo="L"), lambda y: _product_reading(a, b, y),
        lambda: _nth_call(general, "_a_panel", m // NB_MAIN // 2, _skip_panel),
        {"flops": 2 * m * m * n})
    del dstored, db, b
    torch.cuda.empty_cache()
    # max_norm G and permute of rows, bit-equal to the local functions
    secs_norm, nrm = _timed(lambda: dt.max_norm(da, "G"), 2)
    secs_lnorm, lnrm = _timed(lambda: max_norm_local(a, "G"), 2)
    moved = _dm(a)
    moved.data[m // 3, m // 5] = 2 * float(lnrm)
    planted_norm = dt.max_norm(moved, "G")
    del moved
    perm = torch.randperm(m, generator=g, device=DEV)
    secs_perm, pd = _timed(lambda: dt.permute(da, perm, axis=0).data, 2)
    secs_lperm, pl = _timed(lambda: permute_local(a, perm, axis=0), 2)
    perm_equal = torch.equal(pd, pl)
    del pd
    swapped = perm.clone()
    swapped[[0, 1]] = swapped[[1, 0]]
    planted_perm_equal = torch.equal(dt.permute(da, swapped, axis=0).data, pl)
    del pl
    out["max_norm"] = {"seconds": secs_norm, "local_seconds": secs_lnorm,
                       "equal": bool(nrm == lnrm), "planted_equal": bool(planted_norm == lnrm)}
    out["permute_rows"] = {"seconds": secs_perm, "local_seconds": secs_lperm,
                           "bit_equal": perm_equal, "planted_bit_equal": planted_perm_equal}
    require(out["max_norm"]["equal"] and not out["max_norm"]["planted_equal"],
            f"dist max_norm: {out['max_norm']}")
    require(perm_equal and not planted_perm_equal, f"dist permute: {out['permute_rows']}")
    torch.cuda.empty_cache()
    # generalized_to_standard_dist at n = 32768 against the K1 factor of B
    bspd = gen.random_hermitian_positive_definite(g, m, torch.float32)
    potrf_tile.launches = 0
    dl = _dm(dt.potrf(bspd, uplo="L", nb=NB_MAIN), True)
    k1 = potrf_tile.launches
    del bspd
    l = dl.data
    torch.cuda.empty_cache()
    out["generalized_to_standard_dist"] = _dist_and_local(
        "generalized_to_standard_dist",
        lambda: dt.generalized_to_standard_dist(da, dl).data,
        lambda: dt.hegst(a, l, nb=NB_MAIN), lambda r: _hegst_reading(r, a, l)["reading"],
        lambda: _nth_call(blocked, "trsm", m // NB_MAIN // 2, _skip_tile_solve),
        {"flops": 2 * m**3, "potrf_k1_launches": k1})
    require(k1 > 0, "gen_to_std's potrf launched K1")
    _launch_path("potrf_tile", "dist_blas_main potrf n=32768 (gen_to_std's factor)", k1)
    del a, l, da, dl
    torch.cuda.empty_cache()
    out["complex64_conj"] = _conj_case()
    emit("dist_blas_main", bound=BLAS_BOUND, tf32_gate=TF32_GATE, seconds=time.perf_counter() - t0,
         units={"triangular_solver": "max|op(A)X - B| / (m eps32 max|B|)",
                "multiplications": "max|Y - Y64| / (m eps32 max|Y64|)",
                "generalized_to_standard_dist": "max|R - R64| / (n eps32 max|R64|) on "
                                                "R[:4096, :], R[:, :4096]"},
         **out)


def _grid_compare(got, want, exact: bool) -> dict:
    """The grid's gathered result against the 1x1 grid's: bit-equal
    (reading 0, else 1), or max|got - want| / (n eps32 max|want|) within
    GRID_BLAS_BOUND; and the same comparison with the largest entry moved
    by 1e-3 of itself (1.03 in the second units at n = 8192)."""
    def reading(x):
        if exact:
            return float(not torch.equal(x, want))
        return float((x - want).abs().max()) / (want.shape[0] * EPS32 *
                                                float(want.abs().max()))

    r = reading(got)
    moved = got.clone().view(-1)
    j = int(want.abs().argmax())
    moved[j] += 1e-3 * float(want.view(-1)[j])
    return {"reading": r, "planted_reading": reading(moved.view(got.shape)), "exact": exact}


def _blas_grid_rank(grid, device) -> dict:
    """One rank of phase_dist_blas_grid: every new function on the 2x2
    grid at n = 8192, the all-to-all transpose and a right-side solve on a
    1x4 grid of the same ranks at n = 4096, each gathered and (rank 0)
    compared with the 1x1 grid's result on the same card; ring_shift on
    both axes; then the three distributed miniapps with --check."""
    n, nb = N_GRID, NB_MAIN
    g = torch.Generator(device=device).manual_seed(GRID_BLAS_SEED)
    tri = gen.random_triangular(g, n, torch.float32, lower=True)
    herm = gen.random_hermitian(g, n, torch.float32)
    b = gen.random_general(g, (n, n // 2), torch.float32)
    bspd = gen.random_hermitian_positive_definite(g, n, torch.float32)
    l = torch.linalg.cholesky(bspd)
    del bspd
    perm = torch.randperm(n, generator=g, device=device)
    one = dt.Grid((1, 1))

    def dm(x, grid_, pad=False):
        return dt.DistMatrix.from_global(x, nb, grid_, pad_identity=pad)

    calls = {
        "transpose": (lambda G: dm(b, G).transpose(), True),
        "symmetrize": (lambda G: dm(herm, G).symmetrize(lower=True), True),
        "permute_rows": (lambda G: dt.permute(dm(b, G), perm, axis=0), True),
        "permute_cols": (lambda G: dt.permute(dm(b.T.contiguous(), G), perm, axis=1), True),
        "triangular_solver": (lambda G: dt.triangular_solver(dm(tri, G, True), dm(b, G)), False),
        "general_multiplication": (lambda G: dt.general_multiplication(dm(herm, G), dm(b, G)),
                                   False),
        "hermitian_multiplication": (lambda G: dt.hermitian_multiplication(
            dm(torch.tril(herm), G), dm(b, G), uplo="L"), False),
        "triangular_multiplication": (lambda G: dt.triangular_multiplication(
            dm(tri, G), dm(b, G), uplo="L"), False),
        "generalized_to_standard_dist": (lambda G: dt.generalized_to_standard_dist(
            dm(herm, G), dm(l, G, True)), False),
    }
    out = {"rank": grid.rank, "coords": grid.coords, "seconds": {}, "compare": {}}
    for name, (fn, exact) in calls.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(grid)
        torch.cuda.synchronize()
        out["seconds"][name] = time.perf_counter() - t0
        got = res.to_global()
        if grid.rank == 0:
            out["compare"][name] = _grid_compare(got, fn(one).to_global(), exact)
        del res, got
    nrm = dt.max_norm(dm(herm, grid), "G")
    out["max_norm_equal"] = bool(nrm == max_norm_local(herm, "G"))
    out["ring"] = {}
    for axis in ("r", "c"):
        for shift in (1, -1):
            x = torch.tensor([float(grid.rank)], device=device)
            out["ring"][f"{axis}{shift:+d}"] = float(coll.ring_shift(x, axis, grid, shift)[0])
    # the same ranks as a 1x4 grid: the tile-slot all-to-all transpose and
    # a right-side solve (X A = B through two transposes)
    line = dt.Grid((1, 4))
    n4 = N_GRID_LINE
    a4, b4 = tri[:n4, :n4], b[:n4 // 2, :n4].contiguous()
    for name, fn, exact in (
            ("transpose_1x4", lambda G: dm(b[:n4, :n4 // 2], G).transpose(conj=False), True),
            ("triangular_solver_right_1x4", lambda G: dt.triangular_solver(
                dm(a4, G, True), dm(b4, G), side="R"), False)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(line)
        torch.cuda.synchronize()
        out["seconds"][name] = time.perf_counter() - t0
        got = res.to_global()
        if grid.rank == 0:
            out["compare"][name] = _grid_compare(got, fn(one).to_global(), exact)
    del tri, herm, b, l
    torch.cuda.empty_cache()
    out["miniapps"] = {}
    for name, mod in (("triangular_solver", miniapp_triangular_solver),
                      ("triangular_multiplication", miniapp_triangular_multiplication),
                      ("gen_to_std", miniapp_gen_to_std)):
        potrf_tile.launches = 0
        out["miniapps"][name] = {"out": _miniapp(GRID_MINIAPP, mod),
                                 "k1_launches": potrf_tile.launches}
    return out


def phase_dist_blas_grid() -> None:
    """The distributed BLAS-3 on four gloo ranks sharing the card
    (``spawn_grid``): the 2x2 grid at n = 8192, nb = 512, every new function
    against the 1x1 grid's result entry by entry (transpose, symmetrize and
    permute bit-equal, the rest within GRID_BLAS_BOUND in units of n eps32
    max|want|), each comparison shown one entry moved by 1e-3; max_norm
    equal to the local one; ring_shift on both axes; the 1x4 grid at
    n = 4096 (the all-to-all transpose, a right-side solve); and the three
    distributed miniapps with --check (gen_to_std's potrf through K1 on
    every rank)."""
    t0 = time.perf_counter()
    outs = spawn_grid(_blas_grid_rank, (2, 2), backend="gloo", device="cuda", timeout=900)
    seconds = time.perf_counter() - t0
    r0 = outs[0]
    for name, c in r0["compare"].items():
        bound = 0.0 if c["exact"] else GRID_BLAS_BOUND
        require(c["reading"] <= bound < c["planted_reading"],
                f"grid {name}: reading {c['reading']}, planted {c['planted_reading']}")
    for r in outs:
        require(r["max_norm_equal"], f"grid rank {r['rank']}: max_norm differs from local")
        p, q = r["coords"]
        want = {"r+1": ((p - 1) % 2) * 2 + q, "r-1": ((p + 1) % 2) * 2 + q,
                "c+1": p * 2 + (q - 1) % 2, "c-1": p * 2 + (q + 1) % 2}
        require(r["ring"] == {k: float(v) for k, v in want.items()},
                f"grid rank {r['rank']}: ring_shift {r['ring']}")
        require(r["miniapps"]["gen_to_std"]["k1_launches"] > 0,
                f"grid rank {r['rank']}: gen_to_std's potrf launched no K1")
    for name, m in r0["miniapps"].items():
        require("check: PASSED" in m["out"], f"distributed miniapp {name}: {m['out']}")
    require(all(m["out"] == "" for r in outs[1:] for m in r["miniapps"].values()),
            "only rank 0 of the miniapps prints")
    _launch_path("potrf_tile", "dist_blas_grid miniapp_gen_to_std n=4096 (per rank)",
                 r0["miniapps"]["gen_to_std"]["k1_launches"])
    emit("dist_blas_grid", n=N_GRID, n_line=N_GRID_LINE, nb=NB_MAIN, grids=[[2, 2], [1, 4]],
         backend="gloo", ranks_on_one_card=4, seconds=seconds, bound=GRID_BLAS_BOUND,
         units="max|got - want| / (n eps32 max|want|), want the 1x1 grid's result",
         compare=r0["compare"], rank_seconds=[r["seconds"] for r in outs],
         ring=[r["ring"] for r in outs],
         miniapps={k: v["out"].strip().splitlines() for k, v in r0["miniapps"].items()})


# ---------------------------------------------------------------------------
# The distributed eigensolver: eigh_dist, eigvalsh_dist and eigh_gen_dist on
# a 1x1 grid at eigh_main's configuration, and on grids of four gloo ranks
# sharing the card


def _dist_eigh_stages(dm):
    """dt.eigh_dist's stages (dist_driver.eigh_dist, as it runs them), with
    a synchronization after each: (w, v's shard, seconds per stage, the
    stage outputs the planted faults start from). phase_dist_eigh_main
    holds its w bit-equal to the entry point's."""
    tune = dt.get_tune_parameters()
    grid, n = dm.grid, dm.dist.size[0]
    secs, out = {}, {}

    def lap(name, t0):
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return time.perf_counter()

    torch.cuda.synchronize()
    t = time.perf_counter()
    a_sq = ddrv._square_lattice(dm)
    pm = a_sq.dist.padded_size[0]
    band = dt.get_band_size(a_sq.block_size)
    out.update(pm=pm, band=band, grid=grid, n=n, dist=dm.dist, nb=a_sq.block_size)
    out["packed"], out["taus1"] = dist_red2band.reduction_to_band_dist(
        ddrv._pad_fixed(a_sq, n), band)
    t = lap("stage1_red2band", t)
    strips = s23.strips_from_packed_dist(out["packed"], band)
    t = lap("band_to_strips", t)
    d, e, out["vs"], out["taus2"] = s23.band_to_tridiag_dist(strips, pm, band, grid)
    del strips
    t = lap("stage2_band2tridiag", t)
    out["d"], (out["e"], out["phases"]) = d, _phase_normalize(e, dm.data.dtype)
    w, out["q3"], out["m"] = tridiag_eigh_dist(d, out["e"], grid, tune.laed4_max_iter,
                                                 col_align=out["nb"])
    t = lap("stage3_tridiag_dc", t)
    out["q4"] = _dist_stage4(out, out["taus2"])
    t = lap("stage4_bt_band_to_tridiag", t)
    v = _dist_stage5(out, out["q4"], out["taus1"])
    lap("stage5_bt_reduction_to_band_and_layout", t)
    return w[:n], v, secs, out


def _dist_stage4(out, taus2):
    q = out["q3"].to(out["packed"].data.dtype)
    if q.is_complex():
        q = torch.cat([out["phases"], out["phases"].new_ones((out["m"] - out["pm"],))])[:, None] * q
    return s23.bt_band_to_tridiag_dist(
        q, out["vs"], taus2, out["band"], out["pm"], out["grid"],
        group_size=dt.get_tune_parameters().bt_band_to_tridiag_hh_apply_group_size)


def _dist_stage5(out, q4, taus1):
    q = s23.bt_reduction_to_band_dist(q4, out["packed"], taus1, out["band"])
    return s23.cols_to_canonical(q, dist=out["dist"], grid=out["grid"])


def _profiled_idle(call, wall_s: float) -> dict:
    """``call`` once under ``torch.profiler``, tracing the card only: the
    device-busy total (the kernels' and copies' durations, summed from the
    profiler's raw events: eigh_dist launches some 10^5 kernels, which
    ``key_averages`` takes minutes to fold), and the idle share of
    ``wall_s``, an unprofiled run's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            ns, count = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (ns + e.duration_ns(), count + 1)
    busy_ms = sum(ns for ns, _ in by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"device_busy_ms": busy_ms, "wall_ms": wall_s * 1e3,
            "idle_share": 1 - busy_ms / (wall_s * 1e3), "launches": sum(c for _, c in by_name.values()),
            "top": [{"name": k[:80], "ms": ns / 1e6, "launches": c} for k, (ns, c) in top]}


def phase_dist_eigh_main() -> None:
    """The distributed eigensolver on a 1x1 grid at eigh_main's
    configuration (f32, n = 8192, band 128, nb = 512): eigh_dist and eigh
    in turns (dist/local is the metric), K3 counted on eigh_dist's path, a
    staged run timed by stage and held bit-equal to the entry point's
    eigenvalues, the gates (orth, residual, eigenvalues against f64, in
    EIGH_BOUNDS) each beside a planted fault (one stage-4 reflector group
    skipped, one stage-1 reflector not unitary, one subdiagonal entry
    lost), the device's idle share of one eigh_dist; eigvalsh_dist;
    eigh_gen_dist against eigh_gen in turns with their gates beside a
    perturbed factor of B; and complex64 eigh_dist at n = 4096 (K3's
    streamed instance)."""
    n, b = N_EIGH, B_EIGH
    gc.collect()
    torch.cuda.empty_cache()
    one = dt.Grid((1, 1))
    a = _eigh_input(torch.float32)
    a64 = a.double()
    w64 = torch.linalg.eigvalsh(a64)
    dm = dt.DistMatrix.from_global(a, NB_MAIN, one)
    secs = {"dist": [], "local": []}
    res = {}
    part = {}
    t_part = time.perf_counter()
    for which in ("dist", "local", "dist"):
        _counters_reset()
        t, r = _sync_s((lambda: dt.eigh_dist(dm)) if which == "dist" else
                       (lambda: dt.eigh(a, band=b)))
        secs[which].append(t)
        if which == "dist":
            counts = _counters()
            res["dist"] = r
        del r
    part["turns"] = time.perf_counter() - t_part
    w, v = res.pop("dist")
    v = v.data
    launches = counts["band_to_tridiag_strips"]
    require(launches == 1, f"eigh_dist n={n} f32 on 1x1: K3 launches {counts}")
    _launch_path("band_to_tridiag_strips", "eigh_dist n=8192 (1x1)", launches)
    readings = _eigh_readings(a64, w, v, w64)
    _eigh_gates(readings, "eigh_dist n=8192 f32")
    t_part = time.perf_counter()
    ws, vs_, stages, out = _dist_eigh_stages(dm)
    same = {"w_staged": torch.equal(ws, w), "v_staged": torch.equal(vs_.data, v)}
    require(same["w_staged"], f"the staged eigh_dist computes what dt.eigh_dist does ({same})")
    del vs_
    planted = {}
    bad = out["taus2"].clone()
    g_mid = bad.shape[0] // 2
    gsz = dt.get_tune_parameters().bt_band_to_tridiag_hh_apply_group_size
    bad[g_mid:g_mid + gsz] = 0                    # one stage-4 reflector group skipped
    planted["res"] = _eigh_readings(a64, ws, _dist_stage5(out, _dist_stage4(out, bad),
                                                          out["taus1"]), w64)["res"]
    bad = out["taus1"].clone()
    bad[n // 2] *= 1.1                            # one stage-1 reflector not unitary
    planted["orth"] = _eigh_readings(a64, ws, _dist_stage5(out, out["q4"], bad), w64)["orth"]
    e_bad = out["e"].clone()
    e_bad[n // 2] = 0                             # one subdiagonal entry lost
    w_bad = tridiag_eigh_dist(out["d"], e_bad, one, dt.get_tune_parameters().laed4_max_iter)[0]
    planted["eig"] = float((w_bad[:n].double() - w64).abs().max()) / (
        n * EPS32 * float(a64.abs().max()))
    for k, bound in EIGH_BOUNDS.items():
        require(planted[k] > bound, f"the eigh_dist {k} check passes a planted fault "
                f"({planted[k]})")
    del out, w_bad, e_bad, bad
    part["staged_and_planted"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    idle = _profiled_idle(lambda: dt.eigh_dist(dm), min(secs["dist"]))
    part["profile"] = time.perf_counter() - t_part
    t_ev, w_ev = _sync_s(lambda: dt.eigvalsh_dist(dm))
    ev_reading = float((w_ev.double() - w64).abs().max()) / (n * EPS32 * float(a64.abs().max()))
    require(ev_reading <= EIGH_BOUNDS["eig"], f"eigvalsh_dist n={n}: eig {ev_reading}")
    del dm, v, w, ws
    torch.cuda.empty_cache()
    t_part = time.perf_counter()
    gen_out = _dist_gen_main()
    part["eigh_gen"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    c64 = _dist_eigh_c64()
    part["complex64"] = time.perf_counter() - t_part
    DIRECT_TIMES.update({"dlaf_pssyevd": secs["dist"], "dlaf_pssygvd": gen_out["seconds"]["dist"],
                         "dlaf_pcheevd": [c64["seconds"]]})
    emit("dist_eigh_main", n=n, band=b, nb=NB_MAIN, grid=[1, 1], dtype="float32",
         seconds=secs, dist_over_local=min(secs["dist"]) / min(secs["local"]),
         stage_seconds=stages, k3_launches=launches, launches=counts, readings=readings,
         bit_equal=same, bounds=EIGH_BOUNDS, planted_fault_readings=planted,
         idle=idle, eigvalsh_dist_seconds=t_ev, eigvalsh_dist_eig=ev_reading,
         eigh_gen=gen_out, complex64=c64, part_seconds=part)


def _dist_gen_main() -> dict:
    """eigh_gen_dist against eigh_gen at n = 8192 (eigh_gen_main's inputs),
    in turns; their gates beside column n/2 of B's factor scaled by 1.5."""
    n, band = N_EIGH, B_EIGH
    g = torch.Generator(device=DEV).manual_seed(25)
    a = gen.random_hermitian(g, n, torch.float32)
    bm = gen.random_hermitian_positive_definite(g, n, torch.float32)
    a64, b64 = a.double(), bm.double()
    one = dt.Grid((1, 1))
    da = dt.DistMatrix.from_global(a, NB_MAIN, one)
    db = dt.DistMatrix.from_global(bm, NB_MAIN, one, pad_identity=True)
    secs = {"dist": [], "local": []}
    dt.set_tune_parameters(leaf_block_size=NB_MAIN)
    try:
        for which in ("dist", "local"):
            _counters_reset()
            t, r = _sync_s((lambda: dt.eigh_gen_dist(da, db)) if which == "dist" else
                           (lambda: dt.eigh_gen(a, bm, band=band)))
            secs[which].append(t)
            if which == "dist":
                counts = _counters()
                w, x = r[0], r[1].data
            del r
    finally:
        dt.reset_tune_parameters()
    require(counts["potrf_tile"] > 0 and counts["ksub_matmul_masked"] > 0 and
            counts["band_to_tridiag_strips"] == 1,
            f"eigh_gen_dist launched K1, K6 and K3 once: {counts}")
    for k in ("potrf_tile", "ksub_matmul_masked", "band_to_tridiag_strips"):
        _launch_path(k, "eigh_gen_dist n=8192 (1x1)", counts[k])
    readings = _gen_readings(a64, b64, w, x)
    l_bad = torch.linalg.cholesky(bm)
    l_bad[:, n // 2] *= 1.5
    w_bad, x_bad = dt.eigh_gen_dist(da, dt.DistMatrix.from_global(l_bad, NB_MAIN, one, True),
                                    b_factorized=True)
    planted = _gen_readings(a64, b64, w_bad, x_bad.data)
    require(readings["miniapp_gate"], f"eigh_gen_dist n={n}: the miniapp's gates ({readings})")
    for k, bound in GEN_BOUNDS.items():
        require(readings[k] <= bound < planted[k],
                f"eigh_gen_dist {k}: reading {readings[k]}, planted {planted[k]}, bound {bound}")
    return {"n": n, "seconds": secs, "dist_over_local": min(secs["dist"]) / min(secs["local"]),
            "launches": counts, "readings": readings, "bounds": GEN_BOUNDS,
            "planted_fault_readings": planted}


def _dist_eigh_c64() -> dict:
    """complex64 eigh_dist at n = 4096 on 1x1 (K3's streamed instance)."""
    n = N_EIGH_C
    a = _eigh_input(torch.complex64)
    a64 = a.to(torch.complex128)
    w64 = torch.linalg.eigvalsh(a64)
    dm = dt.DistMatrix.from_global(a, NB_MAIN, dt.Grid((1, 1)))
    _counters_reset()
    t, (w, v) = _sync_s(lambda: dt.eigh_dist(dm))
    launches = band_to_tridiag_strips_kernel.launches
    require(launches == 1, f"eigh_dist n={n} c64: K3 launches {launches}")
    _launch_path("band_to_tridiag_strips", "eigh_dist n=4096 complex64 (1x1)", launches)
    readings = _eigh_readings(a64, w, v.data, w64)
    _eigh_gates(readings, "eigh_dist n=4096 c64")
    return {"n": n, "seconds": t, "k3_launches": launches,
            "k3_instance": chase_plan(n, B_EIGH, torch.complex64).instance,
            "readings": readings}


def _capture_stage2(store):
    """dist_stage23's K3 calls, each with (d, e) kept on the host."""
    real = s23.band_to_tridiag_strips_kernel

    def wrap(*args, **kw):
        d, e, vs, taus = real(*args, **kw)
        store.append((d.cpu(), e.cpu()))
        return d, e, vs, taus

    return _patched(s23, "band_to_tridiag_strips_kernel", lambda _: wrap)


def _eig_grid_rank(grid, device) -> dict:
    """One rank of phase_dist_eigh_grid: eigh_dist for each of
    EIG_GRID_CASES (the 2x2 grid, or a 1x4 grid of the same ranks) with
    K3's (d, e) kept, and eigh_gen_dist on 2x2 at N_GEN_GRID; rank 0 also
    runs the 1x1 grid on the same inputs and compares. Then the seven
    eigensolver miniapps' distributed branches with --check."""
    one = dt.Grid((1, 1))
    grids = {(2, 2): grid, (1, 4): dt.Grid((1, 4))}
    out = {"rank": grid.rank, "seconds": {}, "k3": {}, "de": {}, "compare": {}}
    refs = {}
    for gs, n, mode in EIG_GRID_CASES:
        a = gen.random_hermitian(torch.Generator(device=device).manual_seed(EIG_GRID_SEED), n,
                                 torch.float32)
        key = f"{gs[0]}x{gs[1]}-n{n}-{mode}"
        dt.set_tune_parameters(band_to_tridiag_dist_mode=mode)
        store = []
        try:
            band_to_tridiag_strips_kernel.launches = 0
            with _capture_stage2(store):
                t, (w, v) = _sync_s(lambda: dt.eigh_dist(
                    dt.DistMatrix.from_global(a, NB_MAIN, grids[gs])))
        finally:
            dt.reset_tune_parameters()
        out["seconds"][key] = t
        out["k3"][key] = band_to_tridiag_strips_kernel.launches
        out["de"][key] = [(d.numpy(), e.numpy()) for d, e in store]
        vg = v.to_global()
        if grid.rank == 0:
            if n not in refs:
                refs[n] = dt.eigvalsh_dist(dt.DistMatrix.from_global(a, NB_MAIN, one))
            r = _eigh_readings(a.double(), w, vg, torch.linalg.eigvalsh(a.double()))
            r["eig_vs_1x1"] = float((w - refs[n]).abs().max()) / (
                n * EPS32 * float(refs[n].abs().max()))
            out["compare"][key] = r
        del v, vg
    # the first case (2x2, replicated stage 2) once more unchecked (warm),
    # then under the checker
    gs, n, mode = EIG_GRID_CASES[0]
    a = gen.random_hermitian(torch.Generator(device=device).manual_seed(EIG_GRID_SEED), n,
                             torch.float32)
    dt.set_tune_parameters(band_to_tridiag_dist_mode=mode)
    try:
        unchecked_s = _sync_s(lambda: dt.eigh_dist(
            dt.DistMatrix.from_global(a, NB_MAIN, grids[gs])))[0]
        band_to_tridiag_strips_kernel.launches = 0
        r = _checked(lambda: dt.eigh_dist(dt.DistMatrix.from_global(a, NB_MAIN, grids[gs])))
    finally:
        dt.reset_tune_parameters()
    out["checked"] = {**r, "key": f"{gs[0]}x{gs[1]}-n{n}-{mode}", "unchecked_seconds": unchecked_s,
                      "band_to_tridiag_strips": band_to_tridiag_strips_kernel.launches}
    n = N_GEN_GRID
    g = torch.Generator(device=device).manual_seed(EIG_GRID_SEED + 1)
    a = gen.random_hermitian(g, n, torch.float32)
    bm = gen.random_hermitian_positive_definite(g, n, torch.float32)
    potrf_tile.launches = ksub_matmul_masked.launches = band_to_tridiag_strips_kernel.launches = 0
    t, (w, x) = _sync_s(lambda: dt.eigh_gen_dist(dt.DistMatrix.from_global(a, NB_MAIN, grid),
                                                 dt.DistMatrix.from_global(bm, NB_MAIN, grid,
                                                                           True)))
    key = f"gen-2x2-n{n}"
    out["seconds"][key] = t
    out["gen_launches"] = {"potrf_tile": potrf_tile.launches,
                           "ksub_matmul_masked": ksub_matmul_masked.launches,
                           "band_to_tridiag_strips": band_to_tridiag_strips_kernel.launches}
    xg = x.to_global()
    if grid.rank == 0:
        w1, x1 = dt.eigh_gen_dist(dt.DistMatrix.from_global(a, NB_MAIN, one),
                                  dt.DistMatrix.from_global(bm, NB_MAIN, one, True))
        r = _gen_readings(a.double(), bm.double(), w, xg)
        r["eig_vs_1x1"] = float((w - w1).abs().max()) / (n * EPS32 * float(w1.abs().max()))
        out["compare"][key] = r
    del a, bm, x, xg
    torch.cuda.empty_cache()
    out["miniapps"] = {}
    for name, mod, argv in EIG_GRID_MINIAPPS:
        band_to_tridiag_strips_kernel.launches = 0
        out["miniapps"][name] = {"out": _miniapp(argv + EIG_GRID_COMMON, mod),
                                 "k3_launches": band_to_tridiag_strips_kernel.launches}
    # the user surfaces' four-rank checks, on these ranks (one spawn less);
    # phase_surfaces holds them to their gates
    t0 = time.perf_counter()
    out["surfaces"] = _surfaces_rank(grid, device)
    out["surfaces"]["seconds_rank"] = time.perf_counter() - t0
    return out


def phase_dist_eigh_grid() -> None:
    """The distributed eigensolver on four gloo ranks sharing the card
    (``spawn_grid``): eigh_dist on 2x2 and on 1x4 at n = 2048
    in the replicated stage 2 (K3 once on every rank, d and e equal on
    every rank), and at n = 1024 on both in the pipelined one (no K3),
    eigh_gen_dist on 2x2 at n = 2048 (K6 and K3 on every rank, K1 on those
    that hold diagonal tiles), each
    gathered and held to the 1x1 grid's result on rank 0 (eigenvalues
    within n eps32 max|w|) and to the gates (GRID_EIGH_BOUNDS,
    GRID_GEN_BOUNDS and the miniapps'); then the seven eigensolver
    miniapps' distributed branches with --check, and on the same ranks the
    user surfaces' four-rank checks (``_surfaces_rank``), which
    phase_surfaces holds to their gates and reports. The 2x2 replicated
    case also runs once more unchecked and once under the
    collective-schedule checker (``collective_check``: no finding, K3 once
    a rank)."""
    t0 = time.perf_counter()
    outs = spawn_grid(_eig_grid_rank, (2, 2), backend="gloo", device="cuda", timeout=900)
    seconds = time.perf_counter() - t0
    SURFACES_FOUR[:] = [r.pop("surfaces") for r in outs]
    r0 = outs[0]
    de_equal = all(len(r["de"][key]) == len(r0["de"][key]) and
                   all(bool((d == d0).all() and (e == e0).all())
                       for (d, e), (d0, e0) in zip(r["de"][key], r0["de"][key]))
                   for r in outs for key in r["de"])
    for key in r0["k3"]:
        if key.endswith("replicated"):
            _launch_path("band_to_tridiag_strips", f"dist_eigh_grid eigh_dist {key} (per rank)",
                         r0["k3"][key])
    emit("dist_eigh_grid", cases=EIG_GRID_CASES, n_gen=N_GEN_GRID, nb=NB_MAIN, band=B_EIGH,
         bounds=GRID_EIGH_BOUNDS, gen_bounds=GRID_GEN_BOUNDS, backend="gloo",
         ranks_on_one_card=4, seconds=seconds, compare=r0["compare"],
         rank_seconds=[r["seconds"] for r in outs], k3_launches=[r["k3"] for r in outs],
         gen_launches=[r["gen_launches"] for r in outs], d_e_equal_across_ranks=de_equal,
         miniapps={k: v["out"].strip().splitlines() for k, v in r0["miniapps"].items()},
         miniapp_k3_launches={k: v["k3_launches"] for k, v in r0["miniapps"].items()})
    for key, r in r0["compare"].items():
        require(r["eig_vs_1x1"] <= 1.0, f"grid {key}: eigenvalues {r['eig_vs_1x1']} n eps32 "
                "max|w| from the 1x1 grid's")
        require(r["miniapp_gate"], f"grid {key}: the miniapp's gates ({r})")
        for k, bound in (GRID_GEN_BOUNDS if key.startswith("gen") else GRID_EIGH_BOUNDS).items():
            require(r[k] <= bound, f"grid {key}: {k} {r[k]} > {bound}")
    require(de_equal, "grid: K3's d and e differ between ranks")
    for r in outs:
        for key, k3 in r["k3"].items():
            want = 1 if key.endswith("replicated") else 0
            require(k3 == want and len(r["de"][key]) == want,
                    f"grid rank {r['rank']} {key}: K3 launches {k3}")
        # K1 runs on the ranks that hold diagonal tiles, K6 and K3 on every rank
        gl = r["gen_launches"]
        require(gl["ksub_matmul_masked"] > 0 and gl["band_to_tridiag_strips"] == 1,
                f"grid rank {r['rank']} gen: {gl}")
    require(sum(r["gen_launches"]["potrf_tile"] for r in outs) > 0, "grid gen: no K1 launch")
    checked = [r["checked"] for r in outs]
    _require_checked(checked, f"checked grid eigh_dist {checked[0]['key']}")
    require(all(r["band_to_tridiag_strips"] == 1 for r in checked),
            f"checked grid eigh_dist: K3 launches {[r['band_to_tridiag_strips'] for r in checked]}")
    emit("collective_check", where="dist_eigh_grid", case=checked[0]["key"], nb=NB_MAIN,
         first_call_seconds=[r["seconds"][checked[0]["key"]] for r in outs],
         checked=[{k: r[k] for k in ("seconds", "unchecked_seconds", "ops", "group", "p2p",
                                     "band_to_tridiag_strips")} for r in checked])
    for name, m in r0["miniapps"].items():
        require("check: PASSED" in m["out"], f"distributed miniapp {name}: {m['out']}")
    require(all(m["out"] == "" for r in outs[1:] for m in r["miniapps"].values()),
            "only rank 0 of the miniapps prints")


# ---------------------------------------------------------------------------
# The user surfaces: the ScaLAPACK-style API and the C API on the 1x1 grid at
# the main path's sizes, init, matrix files, the rest of DistMatrix and Grid,
# miniapp_communication, and four gloo ranks on the card


def _desc9(n: int, nb: int, ctx: int = 0) -> list:
    """A ScaLAPACK desc[9] of an (n, n) matrix in (nb, nb) blocks."""
    return [1, ctx, n, n, nb, nb, 0, 0, n]


def _count_path(name: str, counts: dict) -> None:
    for k in ("potrf_tile", "ksub_matmul_masked", "band_to_tridiag_strips"):
        if counts[k]:
            KERNELS.setdefault(k, {})
            _launch_path(k, name, counts[k])


def _surface_and_direct(surface, direct, turns):
    """``surface`` (a ScaLAPACK entry's call) and ``direct`` (the same
    driver on a DistMatrix) in ``turns``: seconds of each, the last result
    of each, and the kernel launches of every call (counts set to 0 just
    before each and read just after)."""
    secs, last, launches = {"surface": [], "direct": []}, {}, {"surface": [], "direct": []}
    for route in turns:
        last.pop(route, None)
        _counters_reset()
        t, last[route] = _sync_s(surface if route == "surface" else direct)
        launches[route].append(_counters())
        secs[route].append(t)
    for route, seq in launches.items():
        require(all(c == seq[0] for c in seq), f"{route} launches vary: {seq}")
    require(launches["surface"][0] == launches["direct"][0],
            f"the surface launched what the DistMatrix call does: {launches}")
    return secs, last, launches["surface"][0]


def _surface_only(name, surface):
    """One call of the eigensolver entry ``name``: its seconds beside its
    driver's from phase_dist_eigh_main, the result, and the kernel
    launches of the call (counts set to 0 just before it, read just after)."""
    _counters_reset()
    t, out = _sync_s(surface)
    return {"surface": [t], "direct": DIRECT_TIMES[name]}, out, _counters()


def _split(secs) -> dict:
    best = {r: min(v) for r, v in secs.items()}
    return {"seconds": secs, "surface_over_direct": best["surface"] / best["direct"],
            "surface_extra_s": best["surface"] - best["direct"]}


def _scalapack_potrf(ctx, a, a_np, uplo) -> dict:
    """dlaf_pspotrf at n = 32768 (1x1, nb = 512) in turns with ``cholesky``
    on a DistMatrix: the residual gate beside a factor column x 1.5, the
    factor within ROUTE_C of cholesky's, the other triangle bit-equal to
    the input, K1 and K6 launched."""
    n, nb = N_MAIN, NB_MAIN
    dm = dt.DistMatrix.from_global(a, nb, dt.Grid((1, 1)))
    secs, last, counts = _surface_and_direct(
        lambda: sl.dlaf_pspotrf(uplo, n, a_np, 1, 1, _desc9(n, nb, ctx), ctx),
        lambda: dt.cholesky(dm, uplo=uplo).data, SURFACE_TURNS)
    del dm
    require(counts["potrf_tile"] > 0 and counts["ksub_matmul_masked"] > 0,
            f"dlaf_pspotrf {uplo}: K1 and K6 launched: {counts}")
    _count_path(f"dlaf_pspotrf n=32768 {uplo} (1x1)", counts)
    tri = torch.tril if uplo == "L" else torch.triu
    f = torch.from_numpy(last.pop("surface")).to(DEV)
    direct = tri(last.pop("direct"))
    kept = _other_kept(f, a, uplo)
    deviation = factor_deviation(tri(f), direct, ROUTE_C)
    bit_equal = torch.equal(tri(f), direct)
    del direct
    amax = float(a.abs().max())
    res = _residual(f, a, uplo) / (EPS32 * amax)           # leaves tri(f) in f
    f[:, n // 2] *= 1.5                                     # planted: a factor column x 1.5
    planted = _residual(f, a, uplo) / (EPS32 * amax)
    del f
    require(kept, f"dlaf_pspotrf {uplo}: the other triangle changed")
    require(deviation <= 1.0, f"dlaf_pspotrf {uplo}: factor deviates from cholesky's "
            f"({deviation})")
    require(res <= RES_K < planted, f"dlaf_pspotrf {uplo}: residual {res}, planted {planted}, "
            f"bound {RES_K} eps32 max|A|")
    torch.cuda.empty_cache()
    return {**_split(secs), "launches": counts, "residual_eps_max_a": res,
            "planted_residual_eps_max_a": planted, "factor_deviation": deviation,
            "factor_bit_equal_to_cholesky": bit_equal, "other_triangle_kept": kept}


def _skip_stage4_group(real):
    """Planted fault: the middle reflector group of stage 4 skipped."""
    gsz = dt.get_tune_parameters().bt_band_to_tridiag_hh_apply_group_size

    def wrap(qc, vs, taus2, *args, **kw):
        bad = taus2.clone()
        g = bad.shape[0] // 2
        bad[g:g + gsz] = 0
        return real(qc, vs, bad, *args, **kw)

    return wrap


def _scalapack_syevd(ctx, dtype) -> dict:
    """dlaf_pssyevd n = 8192 (dlaf_pcheevd n = 4096 for complex64) beside
    eigh_dist's seconds on the same input, held to EIGH_BOUNDS beside a
    planted fault: f32 one stage-4 reflector group skipped (a whole call),
    complex64 one returned eigenvector's norm off by 1e-3."""
    n = N_EIGH if dtype == torch.float32 else N_EIGH_C
    name = "dlaf_pssyevd" if dtype == torch.float32 else "dlaf_pcheevd"
    entry = getattr(sl, name)
    a = _eigh_input(dtype)
    a64 = a.to(torch.float64 if dtype == torch.float32 else torch.complex128)
    w64 = torch.linalg.eigvalsh(a64)
    a_np = a.cpu().numpy()
    desc = _desc9(n, NB_MAIN, ctx)
    secs, res, counts = _surface_only(name, lambda: entry("L", n, a_np, 1, 1, desc, ctx))
    require(counts["band_to_tridiag_strips"] == 1, f"{name}: K3 once: {counts}")
    _count_path(f"{name} n={n} (1x1)", counts)
    w, z = (torch.from_numpy(x).to(DEV) for x in res)
    del res
    readings = _eigh_readings(a64, w, z, w64)
    _eigh_gates(readings, f"{name} n={n}")
    out = {**_split(secs), "n": n, "launches": counts, "readings": readings}
    if dtype == torch.float32:
        with _patched(s23, "bt_band_to_tridiag_dist", _skip_stage4_group):
            wb, zb = (torch.from_numpy(x).to(DEV) for x in entry("L", n, a_np, 1, 1, desc, ctx))
        gate = "res"
        planted = _eigh_readings(a64, wb, zb, w64)
    else:
        gate = "orth"
        z[:, n // 2] *= 1.001                   # planted: one eigenvector's norm off by 1e-3
        planted = _eigh_readings(a64, w, z, w64)
    out["planted"] = {gate: planted[gate]}
    require(planted[gate] > EIGH_BOUNDS[gate], f"the {name} {gate} gate passes a planted "
            f"fault ({planted[gate]})")
    return out


def _scalapack_sygvd(ctx) -> dict:
    """dlaf_pssygvd n = 8192 beside eigh_gen_dist's seconds on the same input, and
    dlaf_pssygvd_factorized with B's factor, then with one factor column
    x 1.5, which the gates (GEN_BOUNDS) must reject."""
    n = N_EIGH
    g = torch.Generator(device=DEV).manual_seed(25)
    a = gen.random_hermitian(g, n, torch.float32)
    bm = gen.random_hermitian_positive_definite(g, n, torch.float32)
    a64, b64 = a.double(), bm.double()
    a_np, b_np = a.cpu().numpy(), bm.cpu().numpy()
    desc = _desc9(n, NB_MAIN, ctx)
    secs, res, counts = _surface_only(
        "dlaf_pssygvd", lambda: sl.dlaf_pssygvd("L", n, a_np, b_np, 1, 1, desc, ctx))
    require(counts["potrf_tile"] > 0 and counts["ksub_matmul_masked"] > 0 and
            counts["band_to_tridiag_strips"] == 1, f"dlaf_pssygvd: K1, K6, K3: {counts}")
    _count_path("dlaf_pssygvd n=8192 (1x1)", counts)
    w, x = (torch.from_numpy(v).to(DEV) for v in res)
    del res
    readings = _gen_readings(a64, b64, w, x)
    l_np = torch.linalg.cholesky(bm).cpu().numpy()
    _counters_reset()
    t_fact, (wf, xf) = _sync_s(lambda: sl.dlaf_pssygvd_factorized("L", n, a_np, l_np, 1, 1, desc,
                                                                  ctx))
    fact_counts = _counters()
    fact = _gen_readings(a64, b64, torch.from_numpy(wf).to(DEV), torch.from_numpy(xf).to(DEV))
    l_np[:, n // 2] *= 1.5                      # planted: a factor column x 1.5
    wb, xb = sl.dlaf_pssygvd_factorized("L", n, a_np, l_np, 1, 1, desc, ctx)
    planted = _gen_readings(a64, b64, torch.from_numpy(wb).to(DEV), torch.from_numpy(xb).to(DEV))
    require(fact_counts["band_to_tridiag_strips"] == 1, f"factorized: K3 once: {fact_counts}")
    _count_path("dlaf_pssygvd_factorized n=8192 (1x1)", fact_counts)
    for what, r in (("dlaf_pssygvd", readings), ("dlaf_pssygvd_factorized", fact)):
        require(r["miniapp_gate"], f"{what}: the miniapp's gates ({r})")
        for k, bound in GEN_BOUNDS.items():
            require(r[k] <= bound < planted[k], f"{what} {k}: reading {r[k]}, planted "
                    f"{planted[k]}, bound {bound}")
    return {**_split(secs), "n": n, "launches": counts, "readings": readings,
            "factorized": {"seconds": t_fact, "launches": fact_counts, "readings": fact},
            "planted_fault_readings": planted, "bounds": GEN_BOUNDS}


def _scalapack_sub(ctx) -> dict:
    """dlaf_pspotrf on the (8192, 8192) block at ia = ja = 513 of a 16384
    matrix: the block's factor held to RES_K and its other triangle and
    every entry outside the block bit-equal to the input."""
    n, m, i0 = N_SUB, N_SUB_FULL, NB_MAIN
    g = torch.Generator(device=DEV).manual_seed(31)
    full = torch.rand((m, m), generator=g, device=DEV) - 0.5
    spd = gen.random_hermitian_positive_definite(g, n, torch.float32)
    full[i0:i0 + n, i0:i0 + n] = spd
    full_np = full.cpu().numpy()
    _counters_reset()
    t, out = _sync_s(lambda: sl.dlaf_pspotrf("L", n, full_np, i0 + 1, i0 + 1,
                                             _desc9(m, NB_MAIN, ctx), ctx))
    counts = _counters()
    require(counts["potrf_tile"] > 0 and counts["ksub_matmul_masked"] > 0,
            f"sub-matrix dlaf_pspotrf: K1 and K6 launched: {counts}")
    _count_path("dlaf_pspotrf n=8192 at ia=ja=513 of 16384 (1x1)", counts)
    o = torch.from_numpy(out).to(DEV)
    outside = all(torch.equal(_bits(o[r]), _bits(full[r])) for r in
                  (slice(0, i0), slice(i0 + n, m))) and \
        all(torch.equal(_bits(o[i0:i0 + n, c]), _bits(full[i0:i0 + n, c]))
            for c in (slice(0, i0), slice(i0 + n, m)))
    o0 = o[0, m - 1].clone()
    o[0, m - 1] = torch.nextafter(o0, torch.tensor(float("inf"), device=DEV))
    planted_outside = torch.equal(_bits(o[:i0]), _bits(full[:i0]))   # one entry moved
    o[0, m - 1] = o0
    blk = o[i0:i0 + n, i0:i0 + n].contiguous()
    kept = _other_kept(blk, spd, "L")
    res = _residual(blk, spd, "L") / (EPS32 * float(spd.abs().max()))
    require(outside and kept and not planted_outside, f"sub-matrix dlaf_pspotrf: entries "
            f"outside the factor changed (outside the block kept {outside}, other triangle "
            f"kept {kept}, a moved entry passes {planted_outside})")
    require(res <= RES_K, f"sub-matrix dlaf_pspotrf: residual {res}")
    return {"n": n, "in": m, "ia": i0 + 1, "seconds": t, "launches": counts,
            "residual_eps_max_a": res}


def _c_ppotrf_info() -> dict:
    """c_entry.c_ppotrf on a non-SPD block off the main diagonal (ia = 513,
    ja = 1 of a 1024 matrix, nb = 512): info > 0 from the block's own
    diagonal, the buffer not written."""
    m, nb, n = 1024, 512, 512
    a = np.zeros((m, m), dtype=np.float32, order="F")
    np.fill_diagonal(a, 5.0)
    a[nb:, :nb] = -np.eye(nb, dtype=np.float32)
    before = a.copy(order="F")
    ctx = c_entry.c_create_grid(1, 1)
    try:
        info = c_entry.c_ppotrf("L", n, a.ctypes.data, nb + 1, 1, _desc9(m, nb, ctx), ctx,
                                "float32")
    finally:
        c_entry.c_free_grid(ctx)
    require(info > 0 and np.array_equal(a, before), f"c_ppotrf info on a non-SPD sub-block: {info}")
    return {"info": info, "buffer_unchanged": True}


def phase_scalapack_main() -> None:
    """The ScaLAPACK entries on a 1x1 grid at the main path's sizes, each
    beside its driver on a DistMatrix (surface/direct is the metric;
    dlaf_pspotrf in turns with cholesky, the eigensolver entries beside
    phase_dist_eigh_main's runs of their drivers on the same inputs):
    dlaf_pspotrf n = 32768 L and U (K1, K6), dlaf_pssyevd n = 8192
    (K3), dlaf_pssygvd and _factorized n = 8192 (K1, K6, K3), dlaf_pcheevd
    n = 4096 (K3 streamed), dlaf_pspotrf on a tile-aligned block (ia = ja =
    513, n = 8192 in 16384), each held to its driver's gates beside a
    planted fault; c_ppotrf's info on a non-SPD sub-block."""
    gc.collect()
    torch.cuda.empty_cache()
    ctx = sl.dlaf_create_grid(1, 1)
    report = {}
    part = {}
    try:
        t0 = time.perf_counter()
        a = gen.random_hermitian_positive_definite(
            torch.Generator(device=DEV).manual_seed(0), N_MAIN, torch.float32)
        a_np = a.cpu().numpy()
        for uplo in ("L", "U"):
            report[f"pspotrf_{uplo}"] = _scalapack_potrf(ctx, a, a_np, uplo)
        del a, a_np
        gc.collect()
        torch.cuda.empty_cache()
        part["pspotrf"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        report["pssyevd"] = _scalapack_syevd(ctx, torch.float32)
        part["pssyevd"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        report["pssygvd"] = _scalapack_sygvd(ctx)
        part["pssygvd"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        report["pcheevd"] = _scalapack_syevd(ctx, torch.complex64)
        part["pcheevd"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        report["pspotrf_sub"] = _scalapack_sub(ctx)
        report["c_ppotrf_info"] = _c_ppotrf_info()
        part["sub_and_info"] = time.perf_counter() - t0
    finally:
        sl.dlaf_free_grid(ctx)
    SURFACE_TIMES["pspotrf_L"] = min(report["pspotrf_L"]["seconds"]["surface"])
    SURFACE_TIMES["pssyevd"] = min(report["pssyevd"]["seconds"]["surface"])
    emit("scalapack_main", grid=[1, 1], nb=NB_MAIN, dtype="float32", n_potrf=N_MAIN,
         n_eigh=N_EIGH, turns=SURFACE_TURNS, residual_bound=RES_K, eigh_bounds=EIGH_BOUNDS,
         part_seconds=part, **report)
    gc.collect()
    torch.cuda.empty_cache()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _compile_c(src: str, out: Path) -> Path:
    """A C caller of the C API, linked against the shim."""
    lib = native.build_c_api()
    r = subprocess.run(["gcc", "-O2", src, "-I", str(native.HERE), "-L", str(lib.parent),
                        f"-l{native.C_API_NAME}", f"-Wl,-rpath,{lib.parent}", "-lm", "-o",
                        str(out)], capture_output=True, text=True, timeout=300)
    require(r.returncode == 0, f"gcc {src}: {r.stderr[-3000:]}")
    return out


def phase_c_api() -> None:
    """The C API from plain C on the card: the shim built from the
    checkout (``native.build_c_api``), the port's card driver
    (``native/dlaf_card_driver.c``, checked in C; dlaf_pspotrf n = 32768 and
    dlaf_pssyevd n = 8192 on a 1x1 grid, each call in a process of its own)
    and ``tests/c_api_main.c`` unchanged as four gloo ranks sharing the card
    (f64, n = 64, its 2x2 grid), each of which must exit 0 and print OK.
    These six processes spend most of their time on the host (the C
    caller's strided copies, host-staged collectives); meanwhile this
    process runs the surfaces' own checks (``_surfaces_here``), which
    phase_surfaces reports."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lib = native.build_c_api()
    build_s = time.perf_counter() - t0
    work = native.host_build_dir() / "smoke"
    work.mkdir(parents=True, exist_ok=True)
    card = _compile_c(str(native.HERE / "dlaf_card_driver.c"), work / "dlaf_card_driver")
    main_c = _compile_c(str(Path(__file__).resolve().parent / "tests" / "c_api_main.c"),
                        work / "c_api_main")
    env = dict(os.environ, **{c_entry.DEVICE_ENV: "cuda"})
    port = str(_free_port())
    t0 = time.perf_counter()
    procs = [subprocess.Popen([str(main_c)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=dict(env, RANK=str(k), LOCAL_RANK=str(k),
                                                  WORLD_SIZE="4", LOCAL_WORLD_SIZE="4",
                                                  MASTER_ADDR="localhost", MASTER_PORT=port,
                                                  OMP_NUM_THREADS="1"))
             for k in range(4)]
    procs += [subprocess.Popen([str(card), *args, str(NB_MAIN)], stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True, env=env)
              for args in ((str(N_MAIN), "0"), ("0", str(N_EIGH)))]
    try:
        t1 = time.perf_counter()
        SURFACES_HERE.update(_surfaces_here())
        here_s = time.perf_counter() - t1
        outs = [p.communicate(timeout=900) for p in procs]
        seconds = time.perf_counter() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for k, (p, (out, err)) in enumerate(zip(procs[:4], outs)):
        require(p.returncode == 0 and "OK" in out, f"c_api_main rank {k}: exit {p.returncode} "
                f"{out[-500:]} {err[-2000:]}")
    lines = []
    for p, (out, err) in zip(procs[4:], outs[4:]):
        require(p.returncode == 0, f"card driver exit {p.returncode}: {out[-1000:]} "
                f"{err[-3000:]}")
        line = json.loads(out.strip().splitlines()[-1])["card_driver"]
        for k, bound in line["bounds"].items():
            require(line[k] <= bound, f"card driver {k} {line[k]} > {bound}")
        require(line["ascending"] == 1, "card driver: eigenvalues not ascending")
        lines.append(line)
    emit("c_api", library=str(lib.name), build_seconds=build_s, card_driver=lines,
         c_over_python={"pspotrf": lines[0]["potrf_s"] / SURFACE_TIMES["pspotrf_L"],
                        "pssyevd": lines[1]["syevd_s"] / SURFACE_TIMES["pssyevd"]},
         c_api_main={"ranks": 4, "backend": "gloo",
                     "stdout_rank0": outs[0][0].strip().splitlines()},
         seconds_all_processes=seconds, seconds_surfaces_here=here_s)


def _surfaces_here() -> dict:
    """The surfaces' checks in this process: miniapp_communication 1x1 with
    --check, the eigensolver miniapp at n = 8192 writing --output-file and
    reading it back with --input-file --check (K3 once a run),
    from_callback / sub_matrix / set_sub_matrix at n = 32768 on 1x1
    bit-equal to from_global and slicing, initialize(print_config=True)."""
    part = {}
    t0 = time.perf_counter()
    comm = _miniapp(["-n", MINIAPP_N, "--check", "--nruns", "2"], miniapp_communication)
    require("check: PASSED" in comm, f"miniapp_communication 1x1: {comm}")
    part["communication_1x1"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    work = native.host_build_dir() / "smoke"
    path = str(work / "eigensolver.npz")
    if os.path.exists(path):
        os.remove(path)
    base = ["-n", MINIAPP_N, "--nruns", "1", "--nwarmups", "0"]
    band_to_tridiag_strips_kernel.launches = 0
    wrote = _miniapp(base + ["--check", "--output-file", path], miniapp_eigensolver)
    k3_write = band_to_tridiag_strips_kernel.launches
    band_to_tridiag_strips_kernel.launches = 0
    read = _miniapp(["--input-file", path, "--check", "--nruns", "1", "--nwarmups", "0"],
                    miniapp_eigensolver)
    k3_read = band_to_tridiag_strips_kernel.launches
    f = mio.MatrixFile(path)
    require("check: PASSED" in wrote and "check: PASSED" in read and f"output: {path}" in wrote,
            f"eigensolver miniapp --output-file / --input-file: {wrote} {read}")
    require(f.read("/input").shape == (N_EIGH, N_EIGH) and f.read("/evals").shape == (N_EIGH,)
            and k3_write == 1 and k3_read == 1, f"eigensolver file: K3 {k3_write}, {k3_read}")
    _count_path("miniapp_eigensolver --input-file n=8192",
                {"potrf_tile": 0, "ksub_matmul_masked": 0, "band_to_tridiag_strips": k3_read})
    part["eigensolver_file"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dm1 = _dist_matrix_surfaces(N_MAIN, dt.Grid((1, 1)), DEV)
    require(all(v for k, v in dm1.items() if k.endswith("equal")),
            f"DistMatrix surfaces n=32768 1x1: {dm1}")
    gc.collect()
    torch.cuda.empty_cache()
    part["dist_matrix_1x1"] = time.perf_counter() - t0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dinit.initialize(print_config=True)
    dinit.finalize()
    config = buf.getvalue().strip().splitlines()
    require(config[0] == "dlaf_tpu_torch configuration:" and
            any("eigensolver_min_band" in ln for ln in config), f"print_config: {config}")
    return {"communication_1x1": comm.strip().splitlines(),
            "eigensolver_file": {"wrote": wrote.strip().splitlines(),
                                 "read": read.strip().splitlines(),
                                 "k3_launches": [k3_write, k3_read]},
            "dist_matrix_1x1": {"n": N_MAIN, **dm1}, "print_config": config[:3],
            "part_seconds": part}


def _surfaces_rank(grid, device) -> dict:
    """One of four gloo ranks on the card: miniapp_communication on 2x2,
    from_callback / sub_matrix / set_sub_matrix at n = 8192 bit-equal to
    from_global and slicing, Grid.multihost (one host, and two faked ones),
    and dlaf_pspotrf / dlaf_pssyevd on a 2x2 context at n = 4096 (rank 0
    holds them to the 1x1 grid's on the same card)."""
    out = {"rank": grid.rank, "coords": grid.coords}
    out["communication"] = _miniapp(["-n", "2048", "--grid-rows", "2", "--grid-cols", "2",
                                     "--comm-backend", "gloo", "--check", "--nruns", "2"],
                                    miniapp_communication)
    out["dist_matrix"] = _dist_matrix_surfaces(N_SURF_GRID, grid, device)
    g1 = dt.Grid.multihost()
    g2 = dt.Grid.multihost(host=f"host{grid.rank % 2}")
    out["multihost"] = {"one_host": [g1.grid_size, g1.coords],
                        "two_hosts": [g2.grid_size, g2.coords]}
    n = N_GRID_LINE
    g = torch.Generator(device=device).manual_seed(GRID_SURF_SEED)
    spd = gen.random_hermitian_positive_definite(g, n, torch.float32)
    h = gen.random_hermitian(g, n, torch.float32)
    ctx = sl.dlaf_create_grid(2, 2)
    try:
        t, f = _sync_s(lambda: sl.dlaf_pspotrf("L", n, spd.cpu().numpy(), 1, 1,
                                               _desc9(n, NB_MAIN, ctx), ctx))
        t2, (w, z) = _sync_s(lambda: sl.dlaf_pssyevd("L", n, h.cpu().numpy(), 1, 1,
                                                     _desc9(n, NB_MAIN, ctx), ctx))
    finally:
        sl.dlaf_free_grid(ctx)
    out["seconds"] = {"pspotrf": t, "pssyevd": t2}
    out["sums"] = [float(np.abs(f).sum()), float(np.abs(w).sum())]
    if grid.rank == 0:
        one = dt.Grid((1, 1))
        ref = dt.cholesky(dt.DistMatrix.from_global(spd, NB_MAIN, one), uplo="L").data
        fl = torch.from_numpy(f).to(device)
        got = torch.tril(fl)
        dev_ = factor_deviation(got, torch.tril(ref), ROUTE_C)
        got[n - 1, 0] += 1e-3 * max(1.0, float(ref[n - 1, 0].abs()))
        out["potrf"] = {"deviation": dev_, "other_kept": _other_kept(fl, spd, "L"),
                        "planted_deviation": factor_deviation(got, torch.tril(ref), ROUTE_C)}
        w1 = dt.eigvalsh_dist(dt.DistMatrix.from_global(h, NB_MAIN, one))
        wt, zt = torch.from_numpy(w).to(device), torch.from_numpy(z).to(device)
        r = _eigh_readings(h.double(), wt, zt, torch.linalg.eigvalsh(h.double()))
        r["eig_vs_1x1"] = float((wt - w1).abs().max()) / (n * EPS32 * float(w1.abs().max()))
        out["syevd"] = r
    return out


def _dist_matrix_surfaces(n, grid, device) -> dict:
    """from_callback, sub_matrix and set_sub_matrix at order n on ``grid``
    against from_global and slicing (every comparison bit for bit)."""
    g = torch.Generator(device=device).manual_seed(GRID_SURF_SEED + 1)
    a = torch.rand((n, n), generator=g, device=device) - 0.5
    a_np = a.cpu().numpy()
    nb = NB_MAIN
    ref = dt.DistMatrix.from_global(a, nb, grid)
    t, cb = _sync_s(lambda: dt.DistMatrix.from_callback(lambda idx: a_np[idx], (n, n), nb, grid,
                                                        torch.float32, device=device))
    r = {"from_callback_seconds": t, "from_callback_equal": torch.equal(cb.data, ref.data)}
    del cb
    (oi, oj), (m2, n2) = SUB_OFFSET, (n - 1000, n - 1536)
    rows, cols = slice(oi * nb, oi * nb + m2), slice(oj * nb, oj * nb + n2)
    t, sub = _sync_s(lambda: ref.sub_matrix((oi, oj), (m2, n2)))
    want = dt.DistMatrix.from_global(a[rows, cols].contiguous(), nb, grid)
    r.update(sub_matrix_seconds=t, sub_matrix_equal=torch.equal(sub.data, want.data),
             sub_matrix_global_equal=torch.equal(sub.to_global(), a[rows, cols]))
    del want
    s2 = torch.rand((m2, n2), generator=g, device=device)
    t, upd = _sync_s(lambda: ref.set_sub_matrix(dt.DistMatrix.from_global(s2, nb, grid),
                                                (oi, oj)))
    a[rows, cols] = s2
    r.update(set_sub_matrix_seconds=t,
             set_sub_matrix_equal=torch.equal(upd.data, dt.DistMatrix.from_global(a, nb,
                                                                                   grid).data))
    return r


def phase_surfaces() -> None:
    """The surfaces on four gloo ranks sharing the card (``_surfaces_rank``,
    run on phase_dist_eigh_grid's ranks: miniapp_communication 2x2,
    from_callback / sub_matrix / set_sub_matrix at n = 8192, Grid.multihost,
    the ScaLAPACK entries on a 2x2 context at n = 4096) held to their
    gates, reported with the checks phase_c_api ran in this process
    (``_surfaces_here``)."""
    outs = SURFACES_FOUR
    require(len(outs) == 4, f"the four ranks' surfaces ran: {len(outs)} results")
    r0 = outs[0]
    require("check: PASSED" in r0["communication"] and
            all(r["communication"] == "" for r in outs[1:]), "miniapp_communication 2x2")
    for r in outs:
        require(all(v for k, v in r["dist_matrix"].items() if k.endswith("equal")),
                f"DistMatrix surfaces rank {r['rank']}: {r['dist_matrix']}")
        require(r["sums"] == r0["sums"], "the 2x2 ScaLAPACK results differ between ranks")
    one = sorted(tuple(r["multihost"]["one_host"][1]) for r in outs)
    two = {r["rank"]: r["multihost"]["two_hosts"] for r in outs}
    require(all(tuple(r["multihost"]["one_host"][0]) == (4, 1) for r in outs) and
            one == [(k, 0) for k in range(4)], f"Grid.multihost on one host: {one}")
    # two hosts {0, 2} and {1, 3}: column q holds host q's ranks
    require(all(tuple(v[0]) == (2, 2) for v in two.values()) and
            [tuple(two[k][1]) for k in range(4)] == [(0, 0), (0, 1), (1, 0), (1, 1)],
            f"Grid.multihost on two hosts: {two}")
    require(r0["potrf"]["other_kept"] and r0["potrf"]["deviation"] <= 1.0 <
            r0["potrf"]["planted_deviation"], f"dlaf_pspotrf 2x2: {r0['potrf']}")
    require(r0["syevd"]["eig_vs_1x1"] <= 1.0 and r0["syevd"]["miniapp_gate"] and
            all(r0["syevd"][k] <= b for k, b in GRID_EIGH_BOUNDS.items()),
            f"dlaf_pssyevd 2x2: {r0['syevd']}")
    emit("surfaces", **SURFACES_HERE,
         communication_2x2=r0["communication"].strip().splitlines(),
         four_ranks={"n_dist_matrix": N_SURF_GRID, "n_scalapack": N_GRID_LINE,
                     "seconds_rank": [r["seconds_rank"] for r in outs],
                     "dist_matrix": [r["dist_matrix"] for r in outs],
                     "multihost": [r["multihost"] for r in outs],
                     "seconds": [r["seconds"] for r in outs], "pspotrf": r0["potrf"],
                     "pssyevd": r0["syevd"]})


PHASES = (phase_device, phase_k1, phase_k2, phase_main, phase_miniapp, phase_info,
          phase_k6, phase_dist_main, phase_dist_grid, phase_k3, phase_eigh_main, phase_eigh_c64, phase_miniapp_eigensolver, phase_k45,
          phase_eigh_large_main, phase_eigh_large_cases, phase_blas_main, phase_eigh_gen_main,
          phase_stage_miniapps, phase_dist_blas_main, phase_dist_blas_grid,
          phase_dist_eigh_main, phase_dist_eigh_grid, phase_scalapack_main, phase_c_api,
          phase_surfaces)


def main() -> None:
    seconds = {}
    for phase in PHASES:
        t0 = time.perf_counter()
        phase()
        seconds[phase.__name__] = time.perf_counter() - t0
    emit("timing", seconds=seconds)
    print(smi_line())
    print(json.dumps({"kernels": [KERNELS[k] for k in ("potrf_tile", "ksub_matmul",
                                                       "band_to_tridiag_strips",
                                                       "bt_apply_group", "bt_apply_fused",
                                                       "ksub_matmul_masked")]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
