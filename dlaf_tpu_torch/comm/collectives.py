"""Grid collectives on ``torch.distributed``.

Counterpart of :mod:`dlaf_tpu.comm.collectives`. The JAX functions run
inside one SPMD program and take a mesh axis; these run on every rank of a
:class:`~dlaf_tpu_torch.comm.mesh.Grid` and take the grid too. Broadcast is
``dist.broadcast`` from the owner's global rank (JAX: a masked ``psum``),
gather is ``all_gather`` over the axis group, returned in coordinate order,
the ring shift one ``batch_isend_irecv`` (JAX: ``ppermute``) and the
all-to-all ``all_to_all_single`` over equal slots. Every rank of the axis
(or grid) must make the same call in the same order.

Over a size-1 axis each function is the identity: it returns its input, so
the result may share storage with it (callers pass tensors they computed;
the kernels' wrappers refuse operands that overlap their output).

The gloo backend is the one the caller chose for CUDA tensors on one card
(NCCL refuses two ranks on one GPU): there each call copies the tensor to
the host, runs the collective there and copies the result back. Nothing
picks a backend or swaps one for another.

Each public function first reports its call to the schedule recorder of
:mod:`dlaf_tpu_torch.debug` while one is active (``_recorder``; None
otherwise), before its size-1 early return, so that identity calls are
recorded too. The two process-wide calls, :func:`allgather_object` and
:func:`barrier`, live here for the same reason.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch
import torch.distributed as dist

if TYPE_CHECKING:       # mesh.py calls allgather_object
    from .mesh import Grid

# the active schedule recorder (dlaf_tpu_torch.debug), or None
_recorder = None


def _via_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The contiguous real tensor that carries ``t`` (complex as pairs of
    reals: the point-to-point and all-to-all calls take no complex)."""
    t = t.contiguous()
    return torch.view_as_real(t) if t.is_complex() else t


def _broadcast_(buf: torch.Tensor, src: int, group) -> None:
    """``buf`` (contiguous) from global rank ``src`` to every rank of ``group``, in place."""
    if not _via_host(buf, group):
        dist.broadcast(buf, src=src, group=group)
        return
    host = buf.cpu()
    dist.broadcast(host, src=src, group=group)
    if dist.get_rank() != src:
        buf.copy_(host)


def _send_buffer(x: torch.Tensor, sending: bool) -> torch.Tensor:
    if sending:
        return x.contiguous()
    return torch.empty(x.shape, dtype=x.dtype, device=x.device)


def bcast(x: torch.Tensor, owner: int, axis: str, grid: Grid) -> torch.Tensor:
    """Broadcast ``x`` from the rank with coordinate ``owner`` along
    ``axis`` (reference ``schedule_bcast_send/recv``,
    ``kernels/broadcast.h:39``). On the other ranks ``x`` gives only the
    shape, dtype and device; they get a new tensor."""
    if _recorder is not None:
        _recorder.group("bcast", axis, grid, x, owner=grid.axis_ranks(axis)[owner])
    if grid.axis_size(axis) == 1:
        return x
    buf = _send_buffer(x, grid.axis_index(axis) == owner)
    _broadcast_(buf, grid.axis_ranks(axis)[owner], grid.group(axis))
    return buf


def bcast2d(x: torch.Tensor, owner_rc, grid: Grid) -> torch.Tensor:
    """Broadcast from the single rank ``owner_rc`` = (p, q) to the whole grid."""
    if _recorder is not None:
        _recorder.group("bcast2d", None, grid, x, owner=grid.rank_of(*owner_rc))
    if grid.size == 1:
        return x
    src = grid.rank_of(*owner_rc)
    buf = _send_buffer(x, grid.rank == src)
    _broadcast_(buf, src, None)
    return buf


def _allreduce(x: torch.Tensor, axis, grid: Grid, op) -> torch.Tensor:
    if _recorder is not None:
        _recorder.group("allreduce_sum" if op == dist.ReduceOp.SUM else "allreduce_max",
                        axis, grid, x)
    n = grid.size if axis is None else grid.axis_size(axis)
    if n == 1:
        return x
    group = grid.group(axis)
    out = x.clone(memory_format=torch.contiguous_format)
    if _via_host(out, group):
        host = out.cpu()
        dist.all_reduce(host, op=op, group=group)
        return out.copy_(host)
    dist.all_reduce(out, op=op, group=group)
    return out


def allreduce_sum(x: torch.Tensor, axis, grid: Grid) -> torch.Tensor:
    """Sum over ``axis`` (None: the whole grid) as a new tensor
    (reference ``scheduleAllReduce``)."""
    return _allreduce(x, axis, grid, dist.ReduceOp.SUM)


def allreduce_max(x: torch.Tensor, axis, grid: Grid) -> torch.Tensor:
    """Maximum over ``axis`` (None: the whole grid) of a real tensor, as a
    new tensor (JAX: ``lax.pmax``)."""
    return _allreduce(x, axis, grid, dist.ReduceOp.MAX)


def allgather_tiles(x: torch.Tensor, axis, grid: Grid) -> torch.Tensor:
    """Gather ``x`` over ``axis`` (None: the whole grid, in rank order) ->
    a new leading dimension, in coordinate order (p for ``ROW_AXIS``, q for
    ``COL_AXIS``)."""
    if _recorder is not None:
        _recorder.group("allgather_tiles", axis, grid, x)
    if axis is None:
        if grid.size == 1:
            return x[None]
        ranks = list(range(grid.size))
    else:
        if grid.axis_size(axis) == 1:
            return x[None]
        ranks = grid.axis_ranks(axis)
    group = grid.group(axis)
    send = x.contiguous()
    host = _via_host(send, group)
    if host:
        send = send.cpu()
    parts = [torch.empty_like(send) for _ in ranks]
    dist.all_gather(parts, send, group=group)
    if group is not None:
        parts = [parts[dist.get_group_rank(group, r)] for r in ranks]
    out = torch.stack(parts)
    return out.to(x.device) if host else out


def _exchanged(x: torch.Tensor, out: torch.Tensor, run) -> torch.Tensor:
    """``run(send, recv)`` with x and ``out`` as the real tensors that carry
    them, staged through the host where the default group is gloo and they
    are on the card; returns ``out``."""
    send, recv = _wire(x), _wire(out)
    host = _via_host(send, None)
    if host:
        send, recv = send.cpu(), torch.empty(recv.shape, dtype=recv.dtype)
    run(send, recv)
    if host:
        _wire(out).copy_(recv)
    return out


def sendrecv(x: torch.Tensor, dst, src, shape) -> torch.Tensor:
    """Send ``x`` to global rank ``dst`` and receive from global rank
    ``src`` a new tensor of ``shape`` (x's dtype and device). Both are
    posted together as one ``batch_isend_irecv``, so that ranks that swap
    with each other cannot deadlock. Neither peer may be this rank. A peer
    of None is left out: nothing is sent (``dst``), or nothing is received
    and the result is zeros (``src``), as at the ends of a JAX
    ``ppermute`` that is not a ring."""
    if _recorder is not None:
        dst, src = _recorder.p2p(x, dst, src, shape)

    def run(send, recv):
        ops = ([] if dst is None else [dist.P2POp(dist.isend, send, dst)]) + \
            ([] if src is None else [dist.P2POp(dist.irecv, recv, src)])
        if src is None:
            recv.zero_()
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()

    out = _exchanged(x, torch.empty(shape, dtype=x.dtype, device=x.device), run)
    if _recorder is not None:
        _recorder.p2p_done()
    return out


def ring_shift(x: torch.Tensor, axis: str, grid: Grid, shift: int = 1) -> torch.Tensor:
    """Cyclic shift along ``axis``: the rank at coordinate i receives the
    tensor of coordinate i - shift, as a new tensor (reference P2P ring in
    band_to_tridiag, ``band_to_tridiag/mc.h:438-662``; JAX ``ppermute``).
    ``x`` has the same shape on every rank of the axis. The identity on a
    size-1 axis and for a shift that is a multiple of the axis size."""
    n = grid.axis_size(axis)
    if shift % n == 0:
        if _recorder is not None:   # recorded as the sendrecv it stands for, with no peer
            _recorder.p2p(x, None, None, x.shape)
        return x
    ranks = grid.axis_ranks(axis)
    i = grid.axis_index(axis)
    return sendrecv(x, ranks[(i + shift) % n], ranks[(i - shift) % n], x.shape)


def all_to_all_slots(x: torch.Tensor, grid: Grid) -> torch.Tensor:
    """All-to-all over the whole grid: ``x`` (D, ...) holds one equal slot
    per global rank (D = P·Q, rank order); returns (D, ...) whose slot r
    came from rank r (one ``all_to_all_single`` of equal splits, so that
    gloo needs no variable sizes). The identity on a 1x1 grid."""
    if _recorder is not None:
        _recorder.group("all_to_all_slots", None, grid, x)
    if grid.size == 1:
        return x
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    return _exchanged(x, out, lambda send, recv: dist.all_to_all_single(recv, send))


def allgather_object(obj) -> list:
    """Every rank's ``obj`` (picklable) over the default process group, in
    rank order (``dist.all_gather_object``); ``[obj]`` without a process
    group of more than one rank."""
    if _recorder is not None:
        _recorder.group("allgather_object", None, None, None)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world == 1:
        return [obj]
    out = [None] * world
    dist.all_gather_object(out, obj)
    return out


def barrier() -> None:
    """Wait for every rank of the default process group (``dist.barrier``);
    nothing without a process group of more than one rank."""
    if _recorder is not None:
        _recorder.group("barrier", None, None, None)
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
