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
whole chase sequence alone, with the (k + 1) blocks it needs in shared
memory and V, V2 streamed through a ring of chunks there. That
shared-memory plan is :func:`fused_groups`'s model. The products run on the
tensor cores in three TF32 passes (hi*hi + lo*hi + hi*lo of each f32
operand's two-term TF32 split, as K2's); :func:`bt_apply_group_split_ref`
and :func:`bt_apply_fused_split_ref` emulate that arithmetic in plain
PyTorch, for the checks. The kernel multiplies only the parts of V and V2
that the staggered WY shape can make nonzero (:func:`bt_apply_skip_rule`,
its twin): every slab that ``bt._group_vt_all`` makes is zero elsewhere,
and the kernel takes it to be.

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
from .trailing import tf32_split_matmul

# csrc/bt_apply.cu: kCols columns of E per block, kStages chunks of
# CHUNK_ROWS rows of V (b floats each; of V2^T, CHUNK_ROWS / 2 rows of 2b)
# in the V/V2 ring
COLS = 32
STAGES = 3
CHUNK_ROWS = 32
SMEM_LIMIT = 232448          # bytes of shared memory a block may use (H100)
MIN_BAND, MAX_BAND = 32, 192
K_MAX = 8                    # the largest fusion factor fused_groups offers


def _smem_bytes(k: int, b: int) -> int:
    """Shared memory of one block of the kernel at fusion factor k: a
    carousel of k + 1 E blocks (b x COLS f32: the nact + 1 blocks a step
    touches; the next step's fresh block takes the finished one's slot),
    Y = V^T W kept split as TF32 (hi, lo) pairs (the room of two blocks)
    and the ring through which V and V2 stream (STAGES chunks of
    CHUNK_ROWS x b)."""
    return 4 * ((k + 3) * b * COLS + STAGES * CHUNK_ROWS * b)


def bt_apply_feasible(b: int, dtype) -> bool:
    """Whether the kernels take band ``b`` in ``dtype``: f32 only (the TPU
    kernels are f32 only too), b a multiple of 32 (the b/16 tiles of 16
    rows pair up), at most 192 (2b threads a block: at 384 a thread may
    hold 168 registers) and the k = 1 shared-memory plan within 227 KB. No
    condition on nev: the last column tile is masked."""
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


def _chase(e3, up: int, v, v2, terms) -> None:
    w = e3[up:up + 2].view(-1, e3.shape[2])            # (2b, nev), in place
    if terms is None:
        w -= v2 @ (v.T @ w)
    else:
        w -= tf32_split_matmul(v2, tf32_split_matmul(v.T, w, terms), terms)


def _group(ep2, v, v2, base_blk, ncvalid, b, terms):
    e3 = _blocks(ep2, b)
    for c in range(int(ncvalid)):
        _chase(e3, int(base_blk) + c, v[c], v2[c], terms)
    return ep2


def _fused(ep2, v, v2, beta, nact, v0p, b, terms):
    e3 = _blocks(ep2, b)
    beta, nact, v0p = int(beta), int(nact), int(v0p)
    nsteps = v0p + nact - 1 if nact > 0 else 0
    for t in range(nsteps):
        for i in range(nact):
            if t < v0p + i:
                _chase(e3, beta + nact - 1 - i + t, v[t, i], v2[t, i], terms)
    return ep2


def bt_apply_group_ref(ep2, v, v2, base_blk: int, ncvalid: int, b: int):
    """Plain version of K4: chases c = 0..ncvalid-1 of one group, each the
    two-block update on blocks (base_blk + c, base_blk + c + 1), in place.
    v, v2: (>= ncvalid, 2b, b)."""
    return _group(ep2, v, v2, base_blk, ncvalid, b, None)


def bt_apply_fused_ref(ep2, v, v2, beta: int, nact: int, v0p: int, k: int, b: int):
    """Plain version of K5: the wavefront of k staggered groups, in place.
    v, v2: (>= nsteps, k, 2b, b); v[t, i] is chase t of group i, i = 0 the
    bottom (earliest-applied) valid group; groups i >= nact are skipped."""
    return _fused(ep2, v, v2, beta, nact, v0p, b, None)


def bt_apply_group_split_ref(ep2, v, v2, base_blk: int, ncvalid: int, b: int,
                             terms: int = 3):
    """K4's arithmetic in plain PyTorch, in place: :func:`bt_apply_group_ref`
    with both products of each chase as
    :func:`~dlaf_tpu_torch.ops.kernels.trailing.tf32_split_matmul` computes
    them (``terms`` = 3: the kernel's three TF32 passes; 1 and 2 are the
    planted faults the checks must reject). No route runs it."""
    return _group(ep2, v, v2, base_blk, ncvalid, b, terms)


def bt_apply_fused_split_ref(ep2, v, v2, beta: int, nact: int, v0p: int, k: int, b: int,
                             terms: int = 3):
    """K5's arithmetic in plain PyTorch, in place: :func:`bt_apply_fused_ref`
    with the products split as in :func:`bt_apply_group_split_ref`."""
    return _fused(ep2, v, v2, beta, nact, v0p, b, terms)


def bt_apply_skip_rule(b: int) -> dict:
    """The kernel's zero rule (``csrc/bt_apply.cu`` ``p1_lo``/``p1_hi``,
    ``p1_cols``, ``p2_count``, ``p2_rows``) as boolean masks over one
    chase's V and V2, each (2b, b): ``"v_used"``/``"v2_used"``, the entries
    its tensor-core steps multiply, and ``"v_loaded"``/``"v2_loaded"``, the
    entries its chunks copy to shared memory. An entry outside the used
    mask is never multiplied: the kernel takes it as zero. Column j of V is
    nonzero only in rows b-1-j .. 2b-2-j, column j of V2 only in rows
    0 .. 2b-2-j; the rule is a formula in b, on tiles of 16 rows or
    columns and k8 steps of 8:

    - Y = V^T W: warp w (rows 16w .. 16w+15 of Y, columns of V) runs the
      k8 steps s (rows 8s .. 8s+7 of V) in [b/8 - 2 - 2w, b/4 - 1 - 2w];
      V's chunk p (rows 32p .. 32p+31) loads the columns of the warps with
      a step in it;
    - W -= V2 Y: tile T (rows 16T .. 16T+15 of V2) runs the k8 steps s
      (columns 8s .. 8s+7 of V2) with 16T + 8s <= 2b - 2; V2's chunk q
      (columns 16q .. 16q+15) loads rows 0 .. 2b - 16q - 1, the tiles with
      a step in it.
    """
    nw = b // 16
    masks = {name: torch.zeros((2 * b, b), dtype=torch.bool)
             for name in ("v_used", "v_loaded", "v2_used", "v2_loaded")}
    for w in range(nw):
        lo, hi = b // 8 - 2 - 2 * w, b // 4 - 1 - 2 * w
        masks["v_used"][8 * lo:8 * hi + 8, 16 * w:16 * w + 16] = True
    for p in range(2 * b // CHUNK_ROWS):
        x, y = b // 8 - 5 - 4 * p, b // 4 - 1 - 4 * p
        c0, c1 = 16 * ((x + 1) // 2 if x > 0 else 0), 16 * (min(nw - 1, y // 2) + 1)
        masks["v_loaded"][CHUNK_ROWS * p:CHUNK_ROWS * (p + 1), c0:c1] = True
    for tile in range(2 * nw):
        count = min(b // 8, (2 * b - 2 - 16 * tile) // 8 + 1)
        masks["v2_used"][16 * tile:16 * tile + 16, :8 * count] = True
    half = CHUNK_ROWS // 2
    for q in range(b // half):
        masks["v2_loaded"][:2 * b - 16 * q, half * q:half * (q + 1)] = True
    return masks


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
    # the kernel copies V and V2 in 16-byte pieces, V2 transposed, so that a
    # chunk of V2^T holds one 16-deep stretch of the second product's k
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
    trapezoids zero-padded to 2b rows, v2 = V T^H, as ``bt._group_vt_all``
    makes them; on the card, entries outside :func:`bt_apply_skip_rule`'s
    used masks are taken as zero. Blocks base_blk .. base_blk + ncvalid
    must lie in the buffer."""
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
    phantom groups i >= nact are never read; each chase's slabs as in
    :func:`bt_apply_group`. Blocks beta .. beta + nsteps must lie in the
    buffer."""
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
