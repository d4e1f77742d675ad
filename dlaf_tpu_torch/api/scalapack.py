"""ScaLAPACK-flavored descriptor API.

Counterpart of :mod:`dlaf_tpu.api.scalapack` (the reference's C/ScaLAPACK
layer, ``include/dlaf_c/``, ``src/c_api/``): an integer grid-context
registry (``src/c_api/grid.cpp:1-93``), the ``DLAF_descriptor`` struct
(``include/dlaf_c/desc.h:16``) and typed entry points named after the
ScaLAPACK drop-ins (``dlaf_pspotrf``/``dlaf_pdpotrf``,
``dlaf_pssyevd``/..., ``include/dlaf_c/factorization/cholesky.h:74-86``),
with the same names and contracts.

One process per rank, as the reference's MPI model: every rank of the
context's grid makes the same call and passes the whole global (m, n)
array (the port's ``from_global`` convention), and every rank gets the
whole result back as a numpy array. :func:`from_scalapack_locals` /
:func:`to_scalapack_locals` convert ScaLAPACK's block-cyclic local arrays,
so a ScaLAPACK user's layout round-trips exactly.

Each entry runs through the distributed drivers on the context's grid (a
1x1 grid too): ``cholesky`` (kernels K1 and K6 on the card),
``eigh_dist`` (K3), ``eigh_gen_dist`` (K1, K6, K3), on ``device``: by
default the rank's card, ``cuda:{rank % device_count}``, which raises
where no CUDA device is present; ``device="cpu"`` runs the kernels' plain
versions.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import warnings
from typing import Dict, List

import numpy as np
import torch

from ..comm.launch import rank_device
from ..comm.mesh import Grid
from ..dist import index as ix
from ..spans import span

# ---------------------------------------------------------------------------
# grid registry (reference src/c_api/grid.cpp)

_GRIDS: Dict[int, Grid] = {}
_NEXT_CTX = [1]


def dlaf_create_grid(grid_rows: int, grid_cols: int, order: str = "R") -> int:
    """Create a process grid over the ranks, return an integer context
    handle. ``order`` is the rank->(p, q) ordering, "R"ow or "C"olumn major
    (reference ``dlaf_create_grid``, ``include/dlaf_c/grid.h:31``). Every
    rank calls it; rows x cols must be the number of ranks."""
    if order not in ("R", "C"):
        raise ValueError(f"grid order must be 'R' or 'C', got {order!r}")
    g = Grid((grid_rows, grid_cols), order=order)
    ctx = _NEXT_CTX[0]
    _NEXT_CTX[0] += 1
    _GRIDS[ctx] = g
    return ctx


def dlaf_get_grid(ctx: int) -> Grid:
    return _GRIDS[ctx]


def dlaf_free_grid(ctx: int) -> None:
    _GRIDS.pop(ctx, None)


def dlaf_free_all_grids() -> None:
    _GRIDS.clear()


# ---------------------------------------------------------------------------
# descriptor (reference include/dlaf_c/desc.h:16)


@dataclasses.dataclass
class DLAF_descriptor:
    m: int
    n: int
    mb: int
    nb: int
    isrc: int = 0
    jsrc: int = 0
    i: int = 0
    j: int = 0
    ld: int = 0

    @classmethod
    def from_scalapack(cls, desc) -> "DLAF_descriptor":
        """From a ScaLAPACK desc[9] integer array (DTYPE_, CTXT_, M_, N_,
        MB_, NB_, RSRC_, CSRC_, LLD_) — reference include/dlaf_c/utils.h:35-44."""
        return cls(m=int(desc[2]), n=int(desc[3]), mb=int(desc[4]),
                   nb=int(desc[5]), isrc=int(desc[6]), jsrc=int(desc[7]),
                   ld=int(desc[8]))


def _as_descriptor(desc) -> DLAF_descriptor:
    return desc if isinstance(desc, DLAF_descriptor) else DLAF_descriptor.from_scalapack(desc)


# ---------------------------------------------------------------------------
# ScaLAPACK local-layout conversion (numpy, as in the JAX package)


def to_scalapack_locals(a, desc: DLAF_descriptor, grid_size) -> List[List[np.ndarray]]:
    """Global (m, n) array -> per-rank column-major local arrays
    (ScaLAPACK block-cyclic layout, numroc-sized)."""
    a = np.asarray(a)
    P, Q = grid_size
    out = []
    for p in range(P):
        row = []
        for q in range(Q):
            lm = int(ix.local_size(desc.m, desc.mb, P, p, desc.isrc))
            ln = int(ix.local_size(desc.n, desc.nb, Q, q, desc.jsrc))
            loc = np.zeros((lm, ln), a.dtype, order="F")
            for lt in range(ix.ceil_div(lm, desc.mb)):
                gi = ix.global_tile_from_local_tile(lt, P, p, desc.isrc)
                r0, r1 = gi * desc.mb, min((gi + 1) * desc.mb, desc.m)
                if r0 >= desc.m:
                    continue
                for ltc in range(ix.ceil_div(ln, desc.nb)):
                    gj = ix.global_tile_from_local_tile(ltc, Q, q, desc.jsrc)
                    c0, c1 = gj * desc.nb, min((gj + 1) * desc.nb, desc.n)
                    if c0 >= desc.n:
                        continue
                    loc[lt * desc.mb: lt * desc.mb + (r1 - r0),
                        ltc * desc.nb: ltc * desc.nb + (c1 - c0)] = a[r0:r1, c0:c1]
            row.append(loc)
        out.append(row)
    return out


def from_scalapack_locals(locals_, desc: DLAF_descriptor, grid_size, dtype=None):
    """Per-rank local arrays -> global (m, n) array (inverse of
    :func:`to_scalapack_locals`)."""
    P, Q = grid_size
    dtype = dtype or locals_[0][0].dtype
    a = np.zeros((desc.m, desc.n), dtype)
    for p in range(P):
        for q in range(Q):
            loc = np.asarray(locals_[p][q])
            lm, ln = loc.shape
            for lt in range(ix.ceil_div(lm, desc.mb) if desc.mb else 0):
                gi = ix.global_tile_from_local_tile(lt, P, p, desc.isrc)
                r0, r1 = gi * desc.mb, min((gi + 1) * desc.mb, desc.m)
                if r0 >= desc.m:
                    continue
                for ltc in range(ix.ceil_div(ln, desc.nb) if desc.nb else 0):
                    gj = ix.global_tile_from_local_tile(ltc, Q, q, desc.jsrc)
                    c0, c1 = gj * desc.nb, min((gj + 1) * desc.nb, desc.n)
                    if c0 >= desc.n:
                        continue
                    a[r0:r1, c0:c1] = loc[lt * desc.mb: lt * desc.mb + (r1 - r0),
                                          ltc * desc.nb: ltc * desc.nb + (c1 - c0)]
    return a


# ---------------------------------------------------------------------------
# typed entry points (reference include/dlaf_c/factorization/cholesky.h:32-86,
# eigensolver/eigensolver.h:36-55, eigensolver/gen_eigensolver.h)


def _device(grid: Grid, device) -> torch.device:
    """The device of this rank's call: ``device`` if given, else the
    rank's card (raises where there is none)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("the ScaLAPACK entries run on the card by default and no CUDA "
                           "device is available; pass device='cpu' to run on the CPU")
    return rank_device("cuda", grid.rank)


# ---------------------------------------------------------------------------
# host <-> card copies of the global matrix

# The pinned staging ring: _SLOTS blocks of _BLOCK_BYTES of page-locked host
# memory, allocated on the first staged copy and kept for the process
# (PERF.md §6 has the link and host-copy rates they were chosen from). A
# staged copy moves the matrix in row blocks of at most _BLOCK_BYTES: the
# host copies one block between the caller's pageable memory and a slot
# (torch's CPU copy, parallel over the intra-op threads) while the link
# carries the block before it between a slot and the card.
_BLOCK_BYTES = 32 << 20
_SLOTS = 2

# staged copies made in this process (each direction of each call counts one)
staged_copies = 0


class _StagingRing:
    """The process's pinned slots, behind one lock: calls from several
    threads take turns."""

    def __init__(self):
        self.lock = threading.Lock()
        self.slots = None

    def take(self) -> List[torch.Tensor]:
        """The slots (allocated on first use); hold ``lock`` around the use."""
        if self.slots is None:
            self.slots = [torch.empty(_BLOCK_BYTES, dtype=torch.uint8, pin_memory=True)
                          for _ in range(_SLOTS)]
        return self.slots


_RING = _StagingRing()


def _row_blocks(rows: int, row_bytes: int) -> List[tuple]:
    """Consecutive row ranges (r0, r1) of at most ``_BLOCK_BYTES`` each (one
    row at least) that cover rows 0 .. ``rows`` once, in order."""
    step = max(1, _BLOCK_BYTES // max(1, row_bytes))
    return [(r, min(r + step, rows)) for r in range(0, rows, step)]


def _staged_blocks(t: torch.Tensor, dev: torch.device):
    """The row blocks of a staged copy of ``t`` between the host and
    ``dev``, or None where the copy goes direct: ``dev`` is not a CUDA
    device, ``t`` is not a contiguous matrix, one of its rows does not fit
    a slot, or it fits in one block."""
    if dev.type != "cuda" or t.dim() != 2 or not t.is_contiguous():
        return None
    row_bytes = t.shape[1] * t.element_size()
    if row_bytes > _BLOCK_BYTES:
        return None
    blocks = _row_blocks(t.shape[0], row_bytes)
    return blocks if len(blocks) >= 2 else None


def _slot_view(slot: torch.Tensor, rows: int, like: torch.Tensor) -> torch.Tensor:
    """The first ``rows`` rows of a matrix shaped and typed like ``like``
    in ``slot``'s bytes."""
    cols = like.shape[1]
    return slot[:rows * cols * like.element_size()].view(like.dtype).view(rows, cols)


@contextlib.contextmanager
def _staging():
    """The ring's slots and an event for each, under the ring's lock; every
    event waited on the way out (no copy left in flight to a slot), and
    the copy counted."""
    global staged_copies
    with _RING.lock:
        slots = _RING.take()
        events = [torch.cuda.Event() for _ in slots]
        try:
            yield slots, events
        finally:
            for ev in events:
                ev.synchronize()
        staged_copies += 1


def _staged_to_card(src: torch.Tensor, dev: torch.device, blocks) -> torch.Tensor:
    """``src`` (on the host) as a new tensor on ``dev``: block by block, the
    slot's last copy to the card waited, the block copied into the slot on
    the host, then from the slot to the card on the current stream."""
    dst = torch.empty(src.shape, dtype=src.dtype, device=dev)
    stream = torch.cuda.current_stream(dev)
    with _staging() as (slots, events):
        for i, (r0, r1) in enumerate(blocks):
            k = i % len(slots)
            events[k].synchronize()
            view = _slot_view(slots[k], r1 - r0, src)
            view.copy_(src[r0:r1])
            dst[r0:r1].copy_(view, non_blocking=True)
            events[k].record(stream)
    return dst


def _staged_to_host(t: torch.Tensor, blocks) -> torch.Tensor:
    """``t`` (on the card) as a new pageable host tensor: the copies of the
    first blocks into the slots started on the current stream, then block
    by block the slot's copy waited, the slot drained into the result on
    the host and the copy of the block ``len(slots)`` ahead started."""
    out = torch.empty(t.shape, dtype=t.dtype)
    stream = torch.cuda.current_stream(t.device)
    with _staging() as (slots, events):
        def start(j):
            r0, r1 = blocks[j]
            k = j % len(slots)
            _slot_view(slots[k], r1 - r0, t).copy_(t[r0:r1], non_blocking=True)
            events[k].record(stream)

        for j in range(min(len(slots), len(blocks))):
            start(j)
        for i, (r0, r1) in enumerate(blocks):
            k = i % len(slots)
            events[k].synchronize()
            out[r0:r1].copy_(_slot_view(slots[k], r1 - r0, t))
            if i + len(slots) < len(blocks):
                start(i + len(slots))
    return out


def _on(a, dev: torch.device) -> torch.Tensor:
    """``a`` (a numpy array or tensor) as a tensor on ``dev``, in a
    ``surface.to_card`` span. A read-only array is wrapped as it is (no
    call writes the tensor). A host matrix bound for a CUDA device that
    spans two blocks or more goes through the staging ring."""
    if not isinstance(a, torch.Tensor):
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
            a = torch.from_numpy(np.ascontiguousarray(a))
    blocks = _staged_blocks(a, dev) if a.device.type == "cpu" else None
    with span("surface.to_card", bytes=a.nbytes, route="staged" if blocks else "direct",
              chunks=len(blocks) if blocks else 1):
        return _staged_to_card(a, dev, blocks) if blocks else a.to(dev)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a new numpy array (a view of ``t`` where it is on the CPU),
    in a ``surface.to_host`` span. A matrix on a CUDA device that spans two
    blocks or more comes through the staging ring."""
    blocks = _staged_blocks(t, t.device)
    with span("surface.to_host", bytes=t.nbytes, route="staged" if blocks else "direct",
              chunks=len(blocks) if blocks else 1):
        return (_staged_to_host(t, blocks) if blocks else t.cpu()).numpy()


# rows of the blocks the factor's other triangle is restored through (its
# boolean mask stays below 2048 x n)
_KEEP_ROWS = 2048


def _keep_triangle_(g: torch.Tensor, a: torch.Tensor, uplo: str) -> torch.Tensor:
    """``g`` with its strict other triangle replaced by ``a``'s, entry for
    entry, in place (JAX: ``full[tril/triu indices] = factor``, index
    arrays of n^2/2 int64 that the mask takes the place of)."""
    n = g.shape[1]
    cols = torch.arange(n, device=g.device)
    for r0 in range(0, g.shape[0], _KEEP_ROWS):
        r1 = min(r0 + _KEEP_ROWS, g.shape[0])
        rows = torch.arange(r0, r1, device=g.device)[:, None]
        keep = cols[None, :] <= rows if uplo == "L" else cols[None, :] >= rows
        g[r0:r1] = torch.where(keep, g[r0:r1], a[r0:r1])
    return g


def _run_cholesky(ctx, uplo, a, desc, device=None):
    from ..algos.cholesky import cholesky
    from ..matrix.dist_matrix import DistMatrix
    grid = dlaf_get_grid(ctx)
    dev = _device(grid, device)
    at = _on(a, dev)
    with span("surface.distribute"):
        dm = DistMatrix.from_global(at, desc.mb, grid, pad_identity=True)
    factor = cholesky(dm, uplo=uplo)
    with span("surface.gather"):
        g = factor.to_global()
    del dm, factor
    with span("surface.keep_triangle"):
        g = _keep_triangle_(g, at, uplo)
    return _to_host(g)


def dlaf_cholesky_factorization(ctx: int, uplo: str, a, desc: DLAF_descriptor, device=None):
    """reference ``dlaf_cholesky_factorization_{s,d,c,z}``: the factor in
    the ``uplo`` triangle, the other triangle as ``a`` had it; both uplos
    run the distributed factorization (``algos/cholesky.py``)."""
    return _run_cholesky(ctx, uplo, a, desc, device)


def _as_lower(a: torch.Tensor, uplo: str) -> torch.Tensor:
    """Stored-``uplo`` hermitian -> full matrix whose lower triangle is valid
    (the distributed drivers read the lower triangle)."""
    if uplo == "U":
        return torch.triu(a).mH + torch.triu(a, 1)
    return a


def dlaf_symmetric_eigensolver(ctx: int, uplo: str, a, desc: DLAF_descriptor, device=None):
    """reference ``dlaf_symmetric_eigensolver_{s,d}``: returns (w, z),
    through the registered grid and the distributed driver ``eigh_dist``
    (reference ``src/c_api/eigensolver/eigensolver.cpp``)."""
    from ..algos.eigensolver.dist_driver import eigh_dist
    from ..matrix.dist_matrix import DistMatrix
    grid = dlaf_get_grid(ctx)
    at = _as_lower(_on(a, _device(grid, device)), uplo)
    w, v = eigh_dist(DistMatrix.from_global(at, desc.mb, grid))
    del at
    return _to_host(w), _to_host(v.to_global())


def dlaf_hermitian_eigensolver(ctx, uplo, a, desc, device=None):
    return dlaf_symmetric_eigensolver(ctx, uplo, a, desc, device)


def dlaf_symmetric_generalized_eigensolver(ctx: int, uplo: str, a, b,
                                           desc: DLAF_descriptor,
                                           factorized: bool = False, device=None):
    """reference ``dlaf_symmetric_generalized_eigensolver[_factorized]_{s,d}``,
    through the registered grid and ``eigh_gen_dist``
    (``src/c_api/eigensolver/gen_eigensolver.cpp:1-148``); ``factorized``
    takes b as its Cholesky factor in the ``uplo`` triangle."""
    from ..algos.eigensolver.dist_driver import eigh_gen_dist
    from ..matrix.dist_matrix import DistMatrix
    grid = dlaf_get_grid(ctx)
    dev = _device(grid, device)
    da = DistMatrix.from_global(_as_lower(_on(a, dev), uplo), desc.mb, grid)
    bt = _on(b, dev)
    if factorized:
        db = DistMatrix.from_global(bt if uplo == "L" else bt.mH, desc.mb, grid,
                                    pad_identity=True)
    else:
        db = DistMatrix.from_global(_as_lower(bt, uplo), desc.mb, grid, pad_identity=True)
    del bt
    w, x = eigh_gen_dist(da, db, b_factorized=factorized)
    return _to_host(w), _to_host(x.to_global())


# ScaLAPACK-style aliases (reference dlaf_pspotrf/pdpotrf/pssyevd/...)

def _sub(x, d: DLAF_descriptor, n: int, i0: int, j0: int):
    """The (n, n) block at (i0, j0) and its descriptor (tile-aligned
    offsets, reference DLAF_descriptor i/j, include/dlaf_c/desc.h:16)."""
    if i0 == 0 and j0 == 0 and n == d.m:
        return x, d
    if i0 % d.mb or j0 % d.nb:
        raise ValueError(f"ia/ja must be tile-aligned (the reference requires block "
                         f"alignment), got offsets ({i0}, {j0}) with blocks ({d.mb}, {d.nb})")
    if i0 + n > d.m or j0 + n > d.n:
        raise ValueError(f"the ({n}, {n}) block at ({i0}, {j0}) leaves the ({d.m}, {d.n}) matrix")
    return (np.ascontiguousarray(x[i0:i0 + n, j0:j0 + n]),
            dataclasses.replace(d, m=n, n=n, i=i0, j=j0))


def _scalapack_entry(fn, dtype, name):
    """The ScaLAPACK drop-in ``dlaf_<name>``; with the recorder on
    (:mod:`dlaf_tpu_torch.spans`) each call is a ``surface.<name>`` span."""
    span_name = f"surface.{name}"

    def wrapper(uplo, n, a, ia, ja, desca, ctx, **kw):
        with span(span_name, entry=fn.__name__, n=n):
            desc = _as_descriptor(desca)
            a = np.asarray(a, dtype)
            sub, subdesc = _sub(a, desc, n, ia - 1, ja - 1)
            out = fn(ctx, uplo, sub, subdesc, **kw)
            if sub is not a and isinstance(out, np.ndarray) and out.shape == (n, n):
                full = a.copy()
                full[ia - 1:ia - 1 + n, ja - 1:ja - 1 + n] = out
                return full
            return out
    return wrapper


dlaf_pspotrf = _scalapack_entry(dlaf_cholesky_factorization, np.float32, "pspotrf")
dlaf_pdpotrf = _scalapack_entry(dlaf_cholesky_factorization, np.float64, "pdpotrf")
dlaf_pcpotrf = _scalapack_entry(dlaf_cholesky_factorization, np.complex64, "pcpotrf")
dlaf_pzpotrf = _scalapack_entry(dlaf_cholesky_factorization, np.complex128, "pzpotrf")
dlaf_pssyevd = _scalapack_entry(dlaf_symmetric_eigensolver, np.float32, "pssyevd")
dlaf_pdsyevd = _scalapack_entry(dlaf_symmetric_eigensolver, np.float64, "pdsyevd")
dlaf_pcheevd = _scalapack_entry(dlaf_hermitian_eigensolver, np.complex64, "pcheevd")
dlaf_pzheevd = _scalapack_entry(dlaf_hermitian_eigensolver, np.complex128, "pzheevd")


def _sygvd_entry(dtype, factorized=False):
    """Two-matrix ScaLAPACK entry with tile-aligned ia/ja (and optional
    ib/jb) offsets, routed like the potrf/syevd wrappers (reference
    ``dlaf_pssygvd``: per-matrix (i, j, desc) triplets,
    ``include/dlaf_c/eigensolver/gen_eigensolver.h:147-164``)."""

    def wrapper(uplo, n, a, b, ia, ja, desca, ctx, ib=None, jb=None, descb=None,
                device=None):
        desc = _as_descriptor(desca)
        descb_ = desc if descb is None else _as_descriptor(descb)
        suba, subdesc = _sub(np.asarray(a, dtype), desc, n, ia - 1, ja - 1)
        subb, _ = _sub(np.asarray(b, dtype), descb_, n, (ib or ia) - 1, (jb or ja) - 1)
        return dlaf_symmetric_generalized_eigensolver(
            ctx, uplo, suba, subb, subdesc, factorized=factorized, device=device)

    return wrapper


dlaf_pssygvd = _sygvd_entry(np.float32)
dlaf_pdsygvd = _sygvd_entry(np.float64)
dlaf_pchegvd = _sygvd_entry(np.complex64)
dlaf_pzhegvd = _sygvd_entry(np.complex128)
dlaf_pssygvd_factorized = _sygvd_entry(np.float32, factorized=True)
dlaf_pdsygvd_factorized = _sygvd_entry(np.float64, factorized=True)
dlaf_pchegvd_factorized = _sygvd_entry(np.complex64, factorized=True)
dlaf_pzhegvd_factorized = _sygvd_entry(np.complex128, factorized=True)
