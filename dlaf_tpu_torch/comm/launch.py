"""Run a function on every rank of a process grid, one spawned process each.

:func:`spawn_grid` starts P·Q processes (``multiprocessing`` spawn), joins
them in a ``torch.distributed`` process group of world size P·Q through a
TCP store on ``localhost`` that the calling process hosts (so that no rank
waits on another's start to rendezvous), builds the :class:`Grid` on each
and calls ``fn(grid, device)`` there. It returns the ranks' results in rank
order. ``fn`` and its results cross process boundaries by pickle: ``fn``
must be importable (a module-level function, or a ``functools.partial`` of
one), and results are best plain Python or numpy values.

Rank r runs on ``cuda:{r % device_count}`` for ``device="cuda"`` (several
ranks may share a card: give them the gloo backend, NCCL refuses that), or
on the CPU with one intra-op thread, as an MPI rank would. A rank that
raises stops the run: the others are terminated and the first traceback is
raised here. Every process started is ended before this returns.

Under ``torchrun`` the ranks already exist: build the :class:`Grid` on the
process group ``torchrun`` sets up (as ``miniapp_cholesky`` does) instead.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import queue
import time
import traceback

import torch
import torch.distributed as dist

from .mesh import Grid


def rank_device(device_type: str, rank: int) -> torch.device:
    """The device of ``rank``: ``cuda:{rank % device_count}`` for "cuda"
    (ranks fill the host's cards in turn), else the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device(device_type)


def _rank_main(tasks, rank, grid_size, order, backend, device, port, timeout, results):
    try:
        fn = tasks.get()
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(1)
        wait = datetime.timedelta(seconds=timeout)
        store = dist.TCPStore("localhost", port, is_master=False, timeout=wait)
        dist.init_process_group(backend, store=store, world_size=grid_size[0] * grid_size[1],
                                rank=rank, timeout=wait)
        try:
            out = fn(Grid(grid_size, order=order), dev)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:   # the process boundary: report the traceback to the parent
        results.put((rank, False, traceback.format_exc()))


def spawn_grid(fn, grid_size, backend: str = "gloo", device: str = "cuda",
               order: str = "R", timeout: float = 900.0) -> list:
    """``fn(grid, device)`` on each of the P·Q ranks of a new process grid;
    returns the results in rank order. Raises if a rank raises, exits
    without a result, or the run outlasts ``timeout`` seconds."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"spawn_grid device must be 'cpu' or 'cuda', got {device!r}")
    world = grid_size[0] * grid_size[1]
    ctx = mp.get_context("spawn")
    # fn goes through a queue, not the process arguments: a start() blocks
    # until the child has read its arguments from a pipe, after its
    # imports, so large arguments would start the ranks one after another
    tasks, results = ctx.Queue(), ctx.Queue()
    # the store lives here, on a port the system picks, until every rank is done
    store = dist.TCPStore("localhost", 0, is_master=True, wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=timeout))
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(tasks, r, tuple(grid_size), order, backend, device,
                               store.port, timeout, results))
             for r in range(world)]
    got, failed, started = {}, None, []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
            started.append(p)
            tasks.put(fn)
        while len(got) < world and failed is None:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                gone = [r for r, p in enumerate(procs) if r not in got and p.exitcode is not None]
                if gone:
                    # a rank that has exited may still have a result in flight
                    try:
                        rank, ok, payload = results.get(timeout=5.0)
                    except queue.Empty:
                        failed = f"rank {gone[0]} exited with code {procs[gone[0]].exitcode} " \
                                 "and no result"
                        break
                elif time.monotonic() > deadline:
                    failed = f"spawn_grid timed out after {timeout} s"
                    break
                else:
                    continue
            if ok:
                got[rank] = payload
            else:
                failed = f"rank {rank} raised:\n{payload}"
        if failed is None:
            for p in procs:
                p.join(timeout=60)
    finally:
        for p in started:
            if p.is_alive():
                p.terminate()
        for p in started:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        tasks.cancel_join_thread()    # a rank that died may have left its task unread
        del store
    if failed is not None:
        raise RuntimeError(f"spawn_grid {tuple(grid_size)} ({backend}, {device}): {failed}")
    return [got[r] for r in range(world)]
