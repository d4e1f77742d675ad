"""Run-time collective-schedule checker (deadlock / divergence detector).

Counterpart of :mod:`dlaf_tpu.debug`. The reference walks a traced jaxpr:
one SPMD program runs on every device, so a schedule can diverge only
through rank-dependent control flow around a collective, and the walk finds
it without running anything. The port has no trace. Its distributed
algorithms are eager step loops, one process per rank, and each rank calls
``torch.distributed`` through :mod:`dlaf_tpu_torch.comm.collectives`. So
here, unlike the reference, ``fn`` **executes**: every rank calls it on its
own shard inside a live process group, and the checker records the
schedule that the ranks actually run and compares it across ranks as they
go. In this model a divergent schedule is not a wrong trace but a hung
group, or a collective that pairs mismatched buffers.

Recording. Every public function of ``comm/collectives.py`` reports its
call to the active recorder before anything else (when none is active
that costs one test of a module variable): one :class:`CollectiveOp` with
the group's global ranks, the caller's shape and dtype, the broadcast's
source, the send/receive peers, and the chain of ``dlaf_tpu_torch`` frames
from the entry point to the call. The recorder reads metadata, never
values, so it adds no device synchronisation.

Two kinds of communication, two rules:

  * Group collectives (all but ``sendrecv``): every rank issues the same
    sequence of (prim, axis), and at each index the members of each actual
    group (its sorted global ranks) agree on source, shape and dtype. This
    is the SPMD property that the reference's walk assumes.
  * Point-to-point ``sendrecv``: rank r's k-th send to s meets s's k-th
    receive from r, with the same shape and dtype, posted in the same
    epoch (after the same number of group collectives); otherwise one rank
    waits in the exchange while the other waits in the next group
    collective. Sends and receives are counted apart, so half an exchange
    (a ``None`` peer) pairs like a whole one, and a rank that posts nothing
    takes no part: the diagonal ranks of a square-grid
    ``DistMatrix.transpose``, or the idle steps of the pipelined stage 2.

A call over a group of one rank (an axis of size 1, a 1x1 grid, a ring
shift by a multiple of the axis) is the identity. It is recorded, marked
``local``, but it waits for no one, so neither rule counts it.

Checked mode (:func:`check_collective_safety`, ``record_schedule(check=True)``)
compares before it communicates. Before each group collective every rank
publishes the op's fingerprint (a small tuple) to the process group's
key-value store and waits for every other rank's; before each send or
receive it publishes that half and waits for its counterpart. The end of
``fn`` is itself a fingerprinted step, so a rank that returns meets a rank
that issues one op more. Each step's verdict, "go", "stop" or a stall's
(its timeout and the ranks whose records were missing), is settled once by
the store's compare-and-set, and a rank enters the real call only on
"go". A divergence therefore stops every rank in step, within the time
the ranks take to reach their next step, instead of hanging the group.
"stop" raises :class:`CollectiveDivergence` inside ``fn``, which the
checker turns into a finding. The waits are on the store, not on a side
process group, because a wait there can be polled and given up without
leaving a collective half done.

Findings are strings, as in the reference, and every rank gets the same
list. Each names the ranks, the op index and the call sites:

  * ``cond-divergent``: ranks issue different group ops at one index;
  * ``while-collective``: one rank's group sequence runs past another's
    (it issues an op where another has returned): a loop's trip count, or
    an extra op, differs across ranks. A loop's condition is code like any
    other here, so a collective in a ``while`` condition is seen (the
    reference's walk misses ``while.cond``);
  * ``shape-divergent``: a group's members disagree on source, shape or
    dtype, or a send and its receive on shape or dtype;
  * ``p2p-unpaired``: a send or receive whose peer went on to its next group
    collective (or returned) without posting the counterpart;
  * ``stalled``: a rank's wait at one step outlasted ``TIMEOUT_S`` (a rank
    blocked outside the recorded calls, or computing that long). The call
    stops, and every rank that was waiting for a record still missing
    reports its own ``stalled`` for the ranks it waited for, whichever
    rank's clock stopped the call; the late rank reports none.

Calls that do not go through ``collectives.py`` are not seen: the subgroup
creation inside ``Grid`` (``dist.new_group``, made once per grid) and any
direct ``torch.distributed`` call. Every rank of the process group must
enter a checked call, and in the same order.
"""
from __future__ import annotations

import dataclasses
import json
import pickle
import sys
import time
from typing import Any, Callable, Optional, Sequence

import torch.distributed as dist
from torch.distributed import distributed_c10d

from .comm import collectives

# the functions of comm/collectives.py that report to the recorder
COLLECTIVE_PRIMS = frozenset({"bcast", "bcast2d", "allreduce_sum", "allreduce_max",
                              "allgather_tiles", "all_to_all_slots", "allgather_object",
                              "barrier", "sendrecv"})
# the reference's primitives that each one stands for (``ring_shift`` is
# recorded as the ``sendrecv`` it makes; a broadcast is a masked psum there)
JAX_PRIMS = {"bcast": ("psum", "psum_invariant"), "bcast2d": ("psum", "psum_invariant"),
             "allreduce_sum": ("psum", "psum2", "psum_invariant"), "allreduce_max": ("pmax",),
             "allgather_tiles": ("all_gather",), "all_to_all_slots": ("all_to_all",),
             "sendrecv": ("ppermute",), "allgather_object": (), "barrier": ()}
TIMEOUT_S = 120.0      # the longest a checked rank waits at one step for another

_PKG = __name__.rsplit(".", 1)[0]
_END = ("end", ())     # the (prim, axes) of the step that ends fn
_STOP = "stop"         # set by a rank that stopped, to wake the ranks waiting elsewhere
_STALL = "stall"       # the timeout of the first stall, set before its _STOP
# a waiting rank polls the store, its naps doubling from _NAP0 up to
# _NAP_FAST for the first _FAST_S seconds of a wait (most steps' ranks
# arrive within that), then up to _NAP_SLOW
_NAP0, _NAP_FAST, _NAP_SLOW, _FAST_S = 2e-5, 2e-4, 2e-3, 0.1


class CollectiveDivergence(RuntimeError):
    """Raised inside a checked ``fn`` where its ranks' schedules diverge;
    ``finding`` is the finding this rank made (None where another rank
    made it)."""

    def __init__(self, finding: Optional[str]):
        super().__init__(finding or "stopped by another rank's finding")
        self.finding = finding


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    """One recorded call. ``path`` is the chain of frames from the entry
    point to the call ("module:function:line > ..."), ``axes`` the grid
    axis (() for the whole grid), ``ranks`` the group's global ranks,
    sorted (() for a ``sendrecv``), ``owner`` a broadcast's source (global
    rank), ``dst``/``src`` a ``sendrecv``'s peers and ``recv_shape`` what it
    receives, ``local`` a call over one rank (the identity), ``epoch`` the
    number of group collectives this rank had issued before it."""
    path: str
    prim: str
    axes: tuple
    ranks: tuple = ()
    shape: tuple = ()
    dtype: str = ""
    owner: Optional[int] = None
    dst: Optional[int] = None
    src: Optional[int] = None
    recv_shape: tuple = ()
    local: bool = False
    epoch: int = 0

    def __str__(self):
        return f"{self.prim}{list(self.axes)} at {self.path}"


def _call_path() -> str:
    """The package frames from the entry point to the recorded call, with
    the caller's frame outside the package in front."""
    parts = []
    f = sys._getframe(1)
    while f is not None:
        mod = f.f_globals.get("__name__", "")
        if mod == __name__:
            if parts:       # back at the checker, which called fn
                break
        else:
            parts.append(f"{mod.removeprefix(_PKG + '.')}:{f.f_code.co_name}:{f.f_lineno}")
            if mod != _PKG and not mod.startswith(_PKG + "."):
                break
        f = f.f_back
    return " > ".join(reversed(parts))


def _group_ranks(axis, grid) -> tuple:
    if grid is None:        # the whole process group
        return tuple(range(dist.get_world_size() if dist.is_initialized() else 1))
    if axis is None:
        return tuple(range(grid.size)) if grid.size > 1 else (grid.rank,)
    return tuple(sorted(grid.axis_ranks(axis)))


def _dtype(x) -> str:
    return "" if x is None else str(x.dtype).removeprefix("torch.")


class Recorder:
    """This rank's schedule, recorded while it is the active recorder (a
    context manager; :func:`record_schedule` makes one). ``ops`` holds the
    calls in order; ``findings`` is empty: a plain recorder compares
    nothing."""

    def __init__(self):
        self.ops: list = []
        self.findings: list = []
        self.epoch = 0

    def __enter__(self):
        if collectives._recorder is not None:
            raise RuntimeError("a collective-schedule recorder is already active")
        collectives._recorder = self
        return self

    def __exit__(self, exc_type, exc, tb):
        collectives._recorder = None
        return False

    # the hooks of comm/collectives.py

    def group(self, prim: str, axis, grid, x, owner: Optional[int] = None) -> None:
        ranks = _group_ranks(axis, grid)
        op = CollectiveOp(_call_path(), prim, () if axis is None else (axis,), ranks,
                          () if x is None else tuple(x.shape), _dtype(x), owner,
                          local=len(ranks) == 1, epoch=self.epoch)
        self.ops.append(op)
        if not op.local:
            self._step(op)
            self.epoch += 1

    def p2p(self, x, dst, src, shape) -> tuple:
        """Records a ``sendrecv``; returns the peers cleared to post (both
        here), None for a half that must not be posted."""
        op = CollectiveOp(_call_path(), "sendrecv", (), (), tuple(x.shape), _dtype(x),
                          dst=dst, src=src, recv_shape=tuple(shape),
                          local=dst is None and src is None, epoch=self.epoch)
        self.ops.append(op)
        return self._pair(op)

    def p2p_done(self) -> None:
        """After the posted halves of the last ``sendrecv`` completed."""

    def _step(self, op: CollectiveOp) -> None:
        pass

    def _pair(self, op: CollectiveOp) -> tuple:
        return op.dst, op.src


class _Checker(Recorder):
    """A recorder that compares each step across the ranks of the default
    process group before the step communicates (see the module docstring).
    Keys live under a prefix of their own per checked call."""

    def __init__(self):
        super().__init__()
        base = distributed_c10d._get_default_store()
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        call = base.add(f"{__name__}/calls/{self.rank}", 1)
        self.store = dist.PrefixStore(f"{__name__}/{call}/", base)
        self.sends: dict = {}
        self.recvs: dict = {}
        self.written: list = []     # the keys this rank set
        self.settled: list = []     # the verdict keys it settled
        self.stopped: Optional[CollectiveDivergence] = None
        self.last = "returned before any group op"

    def __exit__(self, exc_type, exc, tb):
        collectives._recorder = None
        if exc is not None and not isinstance(exc, Exception):
            self.store.set(_STOP, "1")      # an interrupt: wake the others, wait for none
            return False
        if exc is None:
            try:
                self._step(CollectiveOp(self.last, *_END, tuple(range(self.world))))
            except CollectiveDivergence as d:
                exc = d
        if isinstance(exc, CollectiveDivergence):
            status = "stopped"
            if exc.finding:
                self.findings.append(exc.finding)
        elif exc is not None:
            status = f"raised {type(exc).__name__}: {exc}"
            self.store.set(_STOP, "1")
        else:
            status = "ok"
        reports = self._reports(status)
        self.findings = sorted({f for fs, _ in reports.values() for f in fs})
        errors = [(q, st) for q, (_, st) in sorted(reports.items()) if st.startswith("raised")]
        if errors and (exc is None or isinstance(exc, CollectiveDivergence)):
            raise RuntimeError(f"rank {errors[0][0]} {errors[0][1]} inside the checked call")
        return isinstance(exc, CollectiveDivergence)

    # the store

    def _set(self, key: str, value) -> None:
        self.store.set(key, pickle.dumps(value))
        self.written.append(key)

    def _get(self, key: str):
        return pickle.loads(self.store.get(key))

    def _has(self, *keys: str) -> bool:
        return self.store.check(list(keys))

    def _settle(self, verdict: str, want: str) -> bytes:
        """Settle the verdict ``verdict`` as ``want`` unless a rank settled
        it first; returns the verdict: b"go", b"stop", or a stall's
        b"stall [timeout, the ranks whose records were missing]"."""
        self.settled.append(verdict)
        return self.store.compare_set(verdict, "", want)

    def _go(self, verdict: str, want: str) -> bool:
        return self._settle(verdict, want) == b"go"

    def _give_up(self, verdict: str, late: bool, missing: Callable[[], list]) -> bytes:
        """Settle ``verdict`` as stopped, on this rank's timeout (``late``)
        or on another rank's stop; returns the verdict as ``_settle``. A
        stop that came from a stall (this rank's timeout, or a stall's
        timeout in the store) is one this rank stalled in too: it settles a
        stall with the ranks ``missing()`` now, the first at a verdict
        giving every rank there one list."""
        t = TIMEOUT_S if late else float(self.store.get(_STALL)) if self._has(_STALL) else None
        return self._settle(verdict, "stop" if t is None else
                            f"stall {json.dumps([float(t), missing()])}")

    def _stall(self, v: bytes) -> Optional[tuple]:
        """(timeout, missing ranks) of the stall's verdict ``v``, else None.
        The stall's timeout goes to the store before this rank sets _STOP,
        so that a rank it wakes knows that a stall stopped the call."""
        if not v.startswith(b"stall"):
            return None
        t, missing = json.loads(v[len(b"stall"):])
        self.store.compare_set(_STALL, "", str(t))
        return t, missing

    def _stalled(self, stall: Optional[tuple], at: str) -> Optional[str]:
        """This rank's finding where ``stall`` (``_stall``'s) stopped its
        wait ``at`` a step: None where no stall did, or where this rank is
        one of the ranks that the stall waited for."""
        if stall is None or self.rank in stall[1]:
            return None
        t, missing = stall
        return (f"stalled: rank {self.rank} was waiting {at} for ranks {missing} when a {t} s "
                "timeout stopped the checked call")

    def _stop(self, finding: Optional[str]) -> CollectiveDivergence:
        self.store.set(_STOP, "1")
        return CollectiveDivergence(finding)

    def _waiting(self, since: float, nap: float) -> tuple:
        """Sleep a little; returns (timed out, another rank stopped, the
        next nap)."""
        waited = time.monotonic() - since
        late = waited > TIMEOUT_S
        if not late:
            time.sleep(nap)
        return late, self._has(_STOP), min(2 * nap, _NAP_FAST if waited < _FAST_S else _NAP_SLOW)

    # group collectives

    def _step(self, op: CollectiveOp) -> None:
        k = self.epoch
        self._set(f"g{k}/{self.rank}", (op.prim, op.axes, op.ranks, op.owner, op.shape,
                                        op.dtype, op.path))
        if op.prim != _END[0]:
            self.last = f"returned after {op}"
        keys = [f"g{k}/{q}" for q in range(self.world)]
        since, nap = time.monotonic(), _NAP0
        while True:
            if self._has(*keys):
                finding = _group_finding(k, [self._get(key) for key in keys])
                v = self._settle(f"v{k}", "stop" if finding else "go")
                if v == b"go":
                    return
                stall = self._stall(v)      # all here, but after a stall's verdict
                raise self._stop(finding if stall is None else
                                 self._stalled(stall, f"at group op #{k} {op}"))
            late, stopped, nap = self._waiting(since, nap)
            if late or stopped:
                v = self._give_up(f"v{k}", late, lambda: [
                    q for q, key in enumerate(keys) if not self._has(key)])
                if v != b"go":
                    raise self._stop(self._stalled(self._stall(v), f"at group op #{k} {op}"))

    # point-to-point

    def _pair(self, op: CollectiveOp) -> tuple:
        e, me = self.epoch, self.rank
        halves = []     # (peer, sender, receiver, index)
        if op.dst is not None:
            i = self.sends[op.dst] = self.sends.get(op.dst, -1) + 1
            halves.append((op.dst, me, op.dst, i))
            self._set(f"s{me}>{op.dst}#{i}", (e, op.shape, op.dtype, op.path))
        if op.src is not None:
            i = self.recvs[op.src] = self.recvs.get(op.src, -1) + 1
            halves.append((op.src, op.src, me, i))
            self._set(f"r{op.src}>{me}#{i}", (e, op.recv_shape, op.dtype, op.path))
        cleared = {}    # send half (a == me) or receive half -> cleared to post
        for peer, a, b, i in halves:
            cleared[a == me] = self._meet(e, peer, a, b, i, give_up=self.stopped is not None)
        return (op.dst if cleared.get(True) else None), (op.src if cleared.get(False) else None)

    def _meet(self, e: int, peer: int, a: int, b: int, i: int, give_up: bool) -> bool:
        """Wait for the counterpart of this rank's half of send #i from
        rank a to rank b; True where the half is cleared to post. A half
        that is not cleared leaves its divergence in ``self.stopped``."""
        mine, theirs = (f"s{a}>{b}#{i}", f"r{a}>{b}#{i}") if a == self.rank else \
            (f"r{a}>{b}#{i}", f"s{a}>{b}#{i}")
        verdict = f"v{a}>{b}#{i}"
        at = f"at send #{i} from rank {a} to rank {b} in epoch {e}"
        since, nap = time.monotonic(), _NAP0
        while not give_up:
            if self._has(theirs):
                send, recv = (self._get(mine), self._get(theirs))[:: 1 if a == self.rank else -1]
                finding = _p2p_finding(a, b, i, send, recv)
                v = self._settle(verdict, "stop" if finding else "go")
                if v == b"go":
                    return True
                stall = self._stall(v)      # both halves here, but after a stall's verdict
                return self._halt(finding if stall is None else self._stalled(stall, at))
            if self._has(f"g{e}/{peer}") and not self._has(theirs):
                # the peer reached its next group op (or returned) without posting
                if not self._go(verdict, "stop"):
                    return self._halt(_unpaired(self.rank, peer, a, i, e, self._get(mine),
                                                self._get(f"g{e}/{peer}")))
                continue
            late, stopped, nap = self._waiting(since, nap)
            if late or stopped:
                v = self._give_up(verdict, late, lambda: [peer])
                if v != b"go":
                    return self._halt(self._stalled(self._stall(v), at))
        return self._go(verdict, "stop") or self._halt(None)

    def _halt(self, finding: Optional[str]) -> bool:
        if self.stopped is None or finding and not self.stopped.finding:
            self.stopped = self._stop(finding)
        return False

    def p2p_done(self) -> None:
        if self.stopped is not None:
            stopped, self.stopped = self.stopped, None
            raise stopped

    # the end

    def _reports(self, status: str) -> dict:
        """Every rank's (findings, status), once all have reported or the
        timeout has passed; then the keys of this call are deleted."""
        self._set(f"rep/{self.rank}", (self.findings, status))
        keys = {q: f"rep/{q}" for q in range(self.world)}
        since, nap = time.monotonic(), _NAP0
        while not self._has(*keys.values()) and time.monotonic() - since <= TIMEOUT_S:
            time.sleep(nap)
            nap = min(2 * nap, _NAP_SLOW)
        reports = {q: self._get(key) for q, key in keys.items() if self._has(key)}
        for q in sorted(set(keys) - set(reports)):
            reports[q] = ([f"stalled: rank {q} did not finish within {TIMEOUT_S} s of rank "
                           f"{self.rank}'s end"], "stalled")
        if len(reports) == self.world and all(st != "stalled" for _, st in reports.values()):
            for key in set(self.written) - {keys[self.rank]} | set(self.settled):
                self.store.delete_key(key)
            if self.store.add("done", 1) == self.world:
                for key in [*keys.values(), "done", _STOP, _STALL]:
                    self.store.delete_key(key)
        return reports


def _group_finding(k: int, fps: list) -> Optional[str]:
    """The finding at group op #k from every rank's fingerprint (prim,
    axes, ranks, owner, shape, dtype, path), or None."""
    kinds: dict = {}
    for r, fp in enumerate(fps):
        kinds.setdefault(fp[:2], []).append(r)
    if len(kinds) > 1:
        def desc(rs):
            prim, axes, *_, path = fps[rs[0]]
            what = "have ended" if (prim, axes) == _END else f"issue {prim}{list(axes)}"
            return f"ranks {rs} {what} ({path})"

        parts = "; ".join(desc(rs) for rs in kinds.values())
        if _END in kinds:
            return (f"while-collective: group op #{k}: {parts}: a loop's trip count or an "
                    "extra op differs across ranks")
        return f"cond-divergent: group op #{k}: {parts}"
    groups: dict = {}
    for r, fp in enumerate(fps):
        groups.setdefault(fp[2], []).append(r)
    for ranks, members in sorted(groups.items()):
        prim, axes = fps[members[0]][:2]
        if sorted(members) != list(ranks):
            return (f"cond-divergent: group op #{k} {prim}{list(axes)}: ranks {members} "
                    f"name the group {list(ranks)}")
        seen: dict = {}
        for r in members:
            seen.setdefault(fps[r][3:6], []).append(r)
        if len(seen) > 1:
            parts = "; ".join(f"ranks {rs} source {o} shape {list(s)} {dt} at {fps[rs[0]][6]}"
                              for (o, s, dt), rs in seen.items())
            return (f"shape-divergent: group op #{k} {prim}{list(axes)} over ranks "
                    f"{list(ranks)}: {parts}")
    return None


def _p2p_finding(a: int, b: int, i: int, send: tuple, recv: tuple) -> Optional[str]:
    """The finding on send #i from rank a to rank b from both halves
    (epoch, shape, dtype, path), or None."""
    if send[:3] == recv[:3]:
        return None
    kind = "p2p-unpaired" if send[0] != recv[0] else "shape-divergent"
    return (f"{kind}: send #{i} from rank {a} to rank {b}: epoch {send[0]} shape "
            f"{list(send[1])} {send[2]} at {send[3]}; its receive: epoch {recv[0]} shape "
            f"{list(recv[1])} {recv[2]} at {recv[3]}")


def _unpaired(me: int, peer: int, a: int, i: int, e: int, mine: tuple, peer_next: tuple) -> str:
    half, other = (f"send #{i} to rank {peer}", "receive") if a == me else \
        (f"receive #{i} from rank {peer}", "send")
    prim, axes, *_, path = peer_next
    went = f"returned ({path})" if (prim, axes) == _END else \
        f"went on to group op #{e} {prim}{list(axes)} at {path}"
    return (f"p2p-unpaired: rank {me}'s {half} in epoch {e} at {mine[3]}: rank {peer} posted no "
            f"{other} for it in epoch {e} and {went}")


def record_schedule(check: bool = False) -> Recorder:
    """A recorder to use as ``with record_schedule(...) as rec:``; after
    the block ``rec.ops`` holds this rank's calls. With ``check`` (and a
    process group of more than one rank) every rank compares each step
    with the others' before it communicates: a divergence ends the block on
    every rank and ``rec.findings``, the same list on every rank, names it
    (empty where the schedules agree)."""
    if check and dist.is_initialized() and dist.get_world_size() > 1:
        return _Checker()
    return Recorder()


def collective_schedule(fn: Callable, *args, **kwargs) -> list:
    """This rank's ordered list of :class:`CollectiveOp` while it runs
    ``fn(*args, **kwargs)`` (which executes)."""
    with record_schedule() as rec:
        fn(*args, **kwargs)
    return rec.ops


def check_collective_safety(fn: Callable, *args, **kwargs) -> list:
    """Runs ``fn(*args, **kwargs)`` on this rank, checked against the
    other ranks (every rank calls this together); returns the findings,
    the same list on every rank; empty = the ranks' schedules agree."""
    with record_schedule(check=True) as rec:
        fn(*args, **kwargs)
    return rec.findings


def assert_same_schedule(fn: Callable, argsets: Sequence[tuple], **kwargs) -> Any:
    """Assert every argset runs ``fn`` with the same collective schedule
    shape on this rank (prim+axes sequence, paths ignored). Returns it."""
    ref: Any = None
    for args in argsets:
        sched = [(op.prim, op.axes) for op in collective_schedule(fn, *args, **kwargs)]
        if ref is None:
            ref = sched
        elif sched != ref:
            raise AssertionError(f"collective schedule diverges across argsets: {ref} vs "
                                 f"{sched}")
    return ref
