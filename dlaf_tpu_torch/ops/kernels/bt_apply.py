"""K4 and K5: the streaming stage-4 apply of ``eigh_large`` — hand-written
Hopper kernels.

Replace the Pallas kernels ``dlaf_tpu/ops/pallas/bt_apply.py``
``bt_apply_group_pallas`` (K4, ``_make_kernel``) and
``bt_apply_fused_pallas`` (K5, ``_make_fused_kernel``). Both apply WY
blocks of the stage-2 reflectors to the SHIFTED eigenvector buffer (buffer
row r = E row r + 1, see :func:`dlaf_tpu_torch.algos.eigensolver.bt.
bt_band_to_tridiag`), viewed as (nblk, b, nev) blocks of b rows: one
chase of one group is the two-block update

    W (2b, nev) <- W - V2 (V^T W),   W = blocks (up, up + 1),
    V (2b, b) the chase's WY trapezoid, V2 = V T^H prefolded.

K4 runs one group's ``ncvalid`` chases on blocks (base + c, base + c + 1),
c ascending. K5 runs k staggered groups in one pass: at step t, group i
(i = 0 the bottom group, applied first) does its chase t on blocks
(beta + nact - 1 - i + t, ... + 1) while t < v0p + i, i ascending; the
groups i >= ``nact`` are phantoms and are skipped. K4 is K5 with k = 1.

The CUDA source is ``dlaf_tpu_torch/csrc/bt_apply.cu``; its header says
what bounds the kernels and how the design answers. Every column of E is
updated on its own, so a block of the kernel owns 32 columns and walks the
whole chase sequence alone, with the (k + 2) blocks it needs in shared
memory and V, V2 streamed through a ring of chunks there. That
shared-memory plan is :func:`fused_groups`'s model.

:func:`bt_apply_group` and :func:`bt_apply_fused` dispatch on the tensor's
device: a CPU tensor takes the plain version (:func:`bt_apply_group_ref`,
:func:`bt_apply_fused_ref`, chase by chase as the Pallas kernels compute);
a CUDA tensor launches the kernel or raises. Both update ``ep2`` in place
and return it. A call with no chase to run (ncvalid = 0, nact = 0 or
nev = 0) launches nothing and leaves ``.launches`` as it was.
"""
from __future__ import annotations

import torch

from . import _build

# csrc/bt_apply.cu: kCols columns of E per block, 2b threads per block,
# kStages chunks of b^2/4 floats in the V/V2 ring
COLS = 32
STAGES = 3
SMEM_LIMIT = 232448          # bytes of shared memory a block may use (H100)
MIN_BAND, MAX_BAND = 32, 256
K_MAX = 8                    # the largest fusion factor fused_groups offers


def _smem_bytes(k: int, b: int) -> int:
    """Shared memory of one block of the kernel at fusion factor k: a
    carousel of k + 2 E blocks (b x COLS f32: the nact + 1 blocks a step
    touches and the next step's fresh block), Y = V^T W (b x COLS) and the
    ring through which V and V2 stream (STAGES chunks of b^2/4)."""
    return 4 * ((k + 3) * b * COLS + STAGES * (b * b // 4))


def bt_apply_feasible(b: int, dtype) -> bool:
    """Whether the kernels take band ``b`` in ``dtype``: f32 only (the TPU
    kernels are f32 only too), b a multiple of 32 (2b threads copy a
    b^2/4 chunk in 16-byte pieces), at most 256 (512 threads a block, so
    that a thread may hold 128 registers) and the k = 1 shared-memory plan
    within 227 KB, which holds up to b = 192. No condition on nev: the last
    column tile is masked."""
    return (dtype == torch.float32 and b % 32 == 0 and MIN_BAND <= b <= MAX_BAND
            and _smem_bytes(1, b) <= SMEM_LIMIT)


def fused_groups(nev: int, b: int, k_max: int = K_MAX) -> int:
    """Largest fusion factor k (a power of two <= k_max) whose carousel
    fits one block's shared memory at band b; 1 = no fusion. At b = 128
    that is k = 8 (224 KB); nev does not enter (a block owns COLS columns
    whatever nev is) and is taken for the JAX function's signature."""
    del nev
    k, cand = 1, 2
    while cand <= k_max and _smem_bytes(cand, b) <= SMEM_LIMIT:
        k, cand = cand, cand * 2
    return k


def _blocks(ep2: torch.Tensor, b: int) -> torch.Tensor:
    nrows, nev = ep2.shape
    if nrows % b:
        raise ValueError(f"shifted buffer rows {nrows} not a multiple of b={b}")
    return ep2.view(nrows // b, b, nev)


def _chase(e3, up: int, v, v2) -> None:
    w = e3[up:up + 2].view(-1, e3.shape[2])            # (2b, nev), in place
    w -= v2 @ (v.T @ w)


def bt_apply_group_ref(ep2, v, v2, base_blk: int, ncvalid: int, b: int):
    """Plain version of K4: chases c = 0..ncvalid-1 of one group, each the
    two-block update on blocks (base_blk + c, base_blk + c + 1), in place.
    v, v2: (>= ncvalid, 2b, b)."""
    e3 = _blocks(ep2, b)
    for c in range(int(ncvalid)):
        _chase(e3, int(base_blk) + c, v[c], v2[c])
    return ep2


def bt_apply_fused_ref(ep2, v, v2, beta: int, nact: int, v0p: int, k: int, b: int):
    """Plain version of K5: the wavefront of k staggered groups, in place.
    v, v2: (>= nsteps, k, 2b, b); v[t, i] is chase t of group i, i = 0 the
    bottom (earliest-applied) valid group; groups i >= nact are skipped."""
    e3 = _blocks(ep2, b)
    beta, nact, v0p = int(beta), int(nact), int(v0p)
    nsteps = v0p + nact - 1 if nact > 0 else 0
    for t in range(nsteps):
        for i in range(nact):
            if t < v0p + i:
                _chase(e3, beta + nact - 1 - i + t, v[t, i], v2[t, i])
    return ep2


def _check_args(ep2, v, v2, b: int, want: tuple, nsteps: int, hi_blk: int, what: str):
    """Raise on what the kernel does not take: v and v2 of shape
    (>= nsteps, *want), blocks up to hi_blk inside the buffer."""
    nrows, nev = ep2.shape
    if not bt_apply_feasible(b, ep2.dtype):
        raise ValueError(f"{what} kernel takes f32 and b % 32 == 0 in "
                         f"[{MIN_BAND}, {MAX_BAND}], got {ep2.dtype}, b={b}")
    for name, t in (("v", v), ("v2", v2)):
        if t.dtype != torch.float32 or t.device != ep2.device:
            raise ValueError(f"{what}: {name} must be f32 on {ep2.device}")
        if tuple(t.shape[1:]) != want or t.shape[0] < nsteps:
            raise ValueError(f"{what}: {name} of shape {tuple(t.shape)}, need "
                             f"(>= {nsteps}, {', '.join(map(str, want))})")
    if not ep2.is_contiguous():
        raise ValueError(f"{what} needs a contiguous buffer")
    if nrows % b or hi_blk >= nrows // b:
        raise ValueError(f"{what}: block {hi_blk} outside the buffer of {nrows // b} "
                         f"blocks of {b} rows")


def _launch(fn: str, ep2, v, v2, b: int, ints, what: str) -> None:
    # the kernel copies V in 16-byte pieces and reads V2 transposed, so that
    # a thread's rows are contiguous
    vc = v.contiguous() if v.data_ptr() % 16 == 0 else v.clone()
    v2t = v2.transpose(-1, -2).contiguous()
    lib = _build.library("bt_apply")
    nev = ep2.shape[1]
    with torch.cuda.device(ep2.device):
        rc = getattr(lib, fn)(ep2.data_ptr(), nev, nev, vc.data_ptr(), v2t.data_ptr(), b,
                              *ints, _build.stream_of(ep2))
    _build.check(rc, lib, what)


def bt_apply_group(ep2, v, v2, base_blk: int, ncvalid: int, b: int):
    """K4: one group's chases on the shifted buffer ``ep2`` (nblk*b, nev),
    in place; returns ``ep2``. v, v2: (>= ncvalid, 2b, b) f32, v's WY
    trapezoids zero-padded to 2b rows, v2 = V T^H. Blocks base_blk ..
    base_blk + ncvalid must lie in the buffer."""
    base_blk, ncvalid = int(base_blk), int(ncvalid)
    if not _build.on_cuda(ep2):
        return bt_apply_group_ref(ep2, v, v2, base_blk, ncvalid, b)
    if base_blk < 0 or ncvalid < 0:
        raise ValueError(f"bt_apply_group: base_blk={base_blk}, ncvalid={ncvalid}")
    _check_args(ep2, v, v2, b, (2 * b, b), ncvalid, base_blk + ncvalid, "bt_apply_group")
    if ncvalid == 0 or ep2.shape[1] == 0:     # no chase to run: nothing launched
        return ep2
    _launch("dlaf_bt_apply_group", ep2, v, v2, b, (base_blk, ncvalid), "bt_apply_group")
    bt_apply_group.launches += 1
    return ep2


bt_apply_group.launches = 0


def bt_apply_fused(ep2, v, v2, beta: int, nact: int, v0p: int, k: int, b: int):
    """K5: k staggered groups' chases in one pass over the shifted buffer,
    in place; returns ``ep2``. v, v2: (>= nsteps, k, 2b, b) f32 with
    nsteps = v0p + nact - 1 (0 when nact = 0); group i has v0p + i chases;
    phantom groups i >= nact are never read. Blocks beta .. beta + nsteps
    must lie in the buffer."""
    beta, nact, v0p, k = int(beta), int(nact), int(v0p), int(k)
    if not _build.on_cuda(ep2):
        return bt_apply_fused_ref(ep2, v, v2, beta, nact, v0p, k, b)
    if not 1 <= k or not 0 <= nact <= k or beta < 0 or (nact > 0 and v0p < 1):
        raise ValueError(f"bt_apply_fused: k={k}, nact={nact}, beta={beta}, v0p={v0p}")
    nsteps = v0p + nact - 1 if nact > 0 else 0
    _check_args(ep2, v, v2, b, (k, 2 * b, b), nsteps, beta + nsteps, "bt_apply_fused")
    if nact == 0 or ep2.shape[1] == 0:        # no chase to run: nothing launched
        return ep2
    _launch("dlaf_bt_apply_fused", ep2, v, v2, b, (k, beta, nact, v0p), "bt_apply_fused")
    bt_apply_fused.launches += 1
    return ep2


bt_apply_fused.launches = 0
