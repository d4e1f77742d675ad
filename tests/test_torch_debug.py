"""The port's collective-schedule checker against the JAX package's.

``dlaf_tpu.debug`` walks a traced jaxpr; ``dlaf_tpu_torch.debug`` records
the schedule that the ranks of a process grid run and compares it across
them as they go (the function executes). Rank code lives in
tests/torch_debug_ranks.py and runs on spawned gloo grids on the CPU: one
spawn of 2x2 (which also builds a 1x4 grid over the same ranks) and one of
2x3, in a background thread while the JAX checker runs here.

 - The reference's seeded cases (tests/test_collective_safety.py:30-95),
   each beside its eager analog on 2x2, where the divergence really
   happens: a collective in one branch of a rank-dependent ``if`` (then the
   collective every rank reaches), a loop whose trip count depends on the
   rank, identical branches, and a ring of three ``ring_shift``s then an
   ``allreduce_sum`` (the scan case). The finding class, or ``[]``, is the
   same from both; the scan's prims map onto JAX's through ``JAX_PRIMS``.
 - A collective in a loop's condition with a rank-dependent trip count:
   the port reports ``while-collective``; JAX's walker reports nothing (it
   records ``while.cond/`` ops but checks only ``while/`` paths).
 - Planted divergences, each its named finding within seconds: a bcast's
   shape differing inside a group, a send posted one group collective
   before its receive, a send/receive shape mismatch, one rank's extra
   ``allreduce_sum`` after ``cholesky``, one rank skipping a ``cholesky``
   panel broadcast; and a rank later than the checker's timeout
   (``stalled``, the timeout cut for the case).
 - The same stall with one rank's timeout forced to pass first, at a
   group collective and at a ring shift's send/receive halves on 1x4: every
   rank that was waiting for the late rank reports its own ``stalled``,
   whichever rank's clock stopped the call.
 - The sweep: every distributed entry point (``cholesky``/``cholesky_info``
   also on a non-SPD input, the distributed BLAS-3, ``max_norm``,
   ``permute``, ``DistMatrix.transpose``/``symmetrize``/``sub_matrix``/
   ``set_sub_matrix``, ``eigh_dist``/``eigvalsh_dist`` with both stage 2s,
   ``eigh_gen_dist``, ``dlaf_pspotrf``, ``dlaf_pssyevd``) on 2x2, 1x4 and
   2x3 at n = 64, nb = 16 (the JAX fixtures' size): no finding.
 - ``assert_same_schedule`` of ``cholesky`` over two SPD inputs on each
   grid, and the 2x2 and 2x3 schedules equal.

Every finding list is the same on every rank. The checker's own timeout
(``TIMEOUT_S``, 120 s) and ``spawn_grid``'s (240 s) bound the run if the
checker breaks.
"""
import ast
import concurrent.futures
import functools
import itertools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from dlaf_tpu import debug as jax_debug
from dlaf_tpu_torch import debug
from dlaf_tpu_torch.comm import collectives as coll
from dlaf_tpu_torch.comm.launch import spawn_grid
from dlaf_tpu_torch.comm.mesh import COL_AXIS, ROW_AXIS, Grid

import torch_debug_ranks as dr

# spawned grid -> the grids built over the same ranks
SPAWNS = {(2, 2): ((1, 4),), (2, 3): ()}
SWEPT = [(gs, key) for gs in ((2, 2), (1, 4), (2, 3)) for key in dr.sweep_keys(gs)]
PLANT_SECONDS = 10.0     # a planted divergence comes back well before the checker's timeout


def _run_port():
    return {gs: spawn_grid(functools.partial(dr.debug_cases, extra), gs, backend="gloo",
                           device="cpu", timeout=240)
            for gs, extra in SPAWNS.items()}


# --- the reference's seeded cases, on a 2x2 CPU mesh --------------------------------

def _shard(body):
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("r", "c"))
    return jax.shard_map(body, mesh=mesh, in_specs=P("r", "c"), out_specs=P("r", "c"))


def _jax_branch(x):
    return jax.lax.cond(jnp.sum(x) > 0, lambda v: v + jax.lax.psum(jnp.sum(v), "c"),
                        lambda v: v, x)


def _jax_trip(x):
    return jax.lax.while_loop(lambda c: jnp.sum(c) < 100.0,
                              lambda c: c + jax.lax.psum(jnp.sum(c), "r"), x)


def _jax_same(x):
    return jax.lax.cond(jnp.sum(x) > 0, lambda v: jax.lax.psum(v, "r"),
                        lambda v: jax.lax.psum(v * 2, "r"), x)


def _jax_scan(x):
    def f(c, _):
        return jax.lax.ppermute(c, "c", [(i, (i + 1) % 2) for i in range(2)]), None
    y, _ = jax.lax.scan(f, x, None, length=3)
    return jax.lax.psum(y, "r")


def _jax_loop_cond(x):
    """A psum in the loop's condition, the bound rank-dependent."""
    limit = 2.0 + 2.0 * jax.lax.axis_index("r")
    return jax.lax.while_loop(lambda c: jax.lax.psum(jnp.sum(c), "c") < limit,
                              lambda c: c + 1.0, x)


JAX_SEEDED = {"branch": _jax_branch, "trip": _jax_trip, "same": _jax_same,
              "scan": _jax_scan, "loop_cond": _jax_loop_cond}


def _jax_verdicts():
    x = jnp.ones((4, 4))
    out = {name: jax_debug.check_collective_safety(_shard(body), x)
           for name, body in JAX_SEEDED.items()}
    out["scan_prims"] = [op.prim for op in jax_debug.collective_schedule(_shard(_jax_scan), x)]
    out["loop_cond_prims"] = [(op.path, op.prim) for op in
                              jax_debug.collective_schedule(_shard(_jax_loop_cond), x)]
    return out


@pytest.fixture(scope="module")
def results():
    """(the ranks' results by spawned grid, JAX's verdicts)."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(_run_port)
        jax_out = _jax_verdicts()
        return port.result(), jax_out


def _classes(findings):
    return sorted({f.split(":", 1)[0] for f in findings})


def _one(res, section, key):
    """The entry on rank 0, after checking that every rank found the same."""
    entries = [r[section][key] for r in res]
    for e in entries:
        assert e["findings"] == entries[0]["findings"], (key, [x["findings"] for x in entries])
    return entries[0]


@pytest.mark.parametrize("name", ["branch", "trip", "same", "scan"])
def test_seeded_verdict_matches_jax(results, name):
    port, jax_out = results
    got = _one(port[(2, 2)], "seeded", name)
    assert _classes(got["findings"]) == _classes(jax_out[name]), (got, jax_out[name])
    want = {"branch": ["cond-divergent"], "trip": ["while-collective"]}.get(name, [])
    assert _classes(got["findings"]) == want, got


def test_scan_prims_map_to_jax(results):
    """Three sendrecvs then an allreduce_sum: JAX's ppermute (once in the
    scan body) then psum_invariant, through JAX_PRIMS with repeats
    collapsed."""
    port, jax_out = results
    prims = port[(2, 2)][0]["scan_prims"]
    assert prims == ["sendrecv"] * 3 + ["allreduce_sum"]
    collapsed = [p for p, _ in itertools.groupby(prims)]
    assert len(collapsed) == len(jax_out["scan_prims"]) == 2
    for ours, theirs in zip(collapsed, jax_out["scan_prims"]):
        assert theirs in debug.JAX_PRIMS[ours], (ours, theirs)


def test_loop_condition_port_flags_jax_misses(results):
    """The reference records the psum in the loop's condition (path
    ``while.cond/``) but checks only ``while/`` paths: no finding. The
    port's loop condition runs like any code and diverges in trip count."""
    port, jax_out = results
    [(path, prim)] = jax_out["loop_cond_prims"]
    assert path == "while.cond/" and prim in debug.JAX_PRIMS["allreduce_sum"], (path, prim)
    assert jax_out["loop_cond"] == []
    got = _one(port[(2, 2)], "seeded", "loop_cond")
    assert _classes(got["findings"]) == ["while-collective"], got
    # ranks of grid row 1 issue one condition sum more than grid row 0's
    assert [r["seeded"]["loop_cond"]["group"] for r in port[(2, 2)]] == [2, 2, 3, 3]


@pytest.mark.parametrize("plant", sorted(dr.PLANTS))
def test_plant_named_finding(results, plant):
    port, _ = results
    got = _one(port[(2, 2)], "plants", plant)
    assert _classes(got["findings"]) == [dr.PLANT_FINDINGS[plant]], got
    assert len(got["findings"]) == 1
    f = got["findings"][0]
    assert "rank" in f and "#" in f and f.count("torch_debug_ranks:") >= 2, f
    assert max(r["plants"][plant]["seconds"] for r in port[(2, 2)]) < PLANT_SECONDS


def test_stalled_rank_reported(results):
    """A rank that reaches a step later than the checker's timeout: the
    ranks that waited for it each report ``stalled``; nobody hangs."""
    port, _ = results
    runs = [r["stall"] for r in port[(2, 2)]]
    assert all(r["findings"] == runs[0]["findings"] for r in runs)
    assert _classes(runs[0]["findings"]) == ["stalled"], runs[0]
    assert len(runs[0]["findings"]) == 3 and all("for ranks [0]" in f for f in runs[0]["findings"])
    assert max(r["seconds"] for r in runs) < dr.STALL_S + 2 * dr.STALL_TIMEOUT


def _stalled_by_rank(port, key) -> dict:
    """{rank: its finding} of a stall case, after checking that every rank
    found the same list, one ``stalled`` finding a waiting rank, within the
    late rank's delay and two timeouts."""
    runs = [r[key] for r in port[(2, 2)]]
    findings = runs[0]["findings"]
    assert all(r["findings"] == findings for r in runs), [r["findings"] for r in runs]
    assert _classes(findings) == ["stalled"], findings
    by_rank = {int(f.split()[2]): f for f in findings}
    assert len(by_rank) == len(findings), findings
    assert max(r["seconds"] for r in runs) < dr.FORCED_S + 2 * dr.STALL_TIMEOUT
    return by_rank


def test_forced_stall_every_waiting_rank_reports(results):
    """plant_stall with rank 1's timeout (1.5 s) passing before the
    others' (2.0 s): ranks 2 and 3 are stopped by rank 1's verdict before
    their own timeout, and still report their wait; rank 0, late, reports
    none; the timeout named is the one that passed."""
    port, _ = results
    by_rank = _stalled_by_rank(port, "forced_stall")
    assert sorted(by_rank) == [1, 2, 3], by_rank
    for q, f in by_rank.items():
        assert "group op #0 allreduce_sum[]" in f and "for ranks [0]" in f, f
        assert f"{dr.FORCED_TIMEOUTS[1]} s" in f, f


def test_forced_ring_stall_every_waiting_rank_reports(results):
    """A ring shift along 1x4 with rank 0 late and rank 1's timeout passing
    first: rank 1's receive and rank 3's send wait for rank 0's halves (two
    pair verdicts), rank 2 waits at the end of the call; each reports."""
    port, _ = results
    by_rank = _stalled_by_rank(port, "forced_ring_stall")
    assert sorted(by_rank) == [1, 2, 3], by_rank
    assert "at send #0 from rank 0 to rank 1 in epoch 0 for ranks [0]" in by_rank[1], by_rank
    assert "at send #0 from rank 3 to rank 0 in epoch 0 for ranks [0]" in by_rank[3], by_rank
    assert "group op #0" in by_rank[2] and "for ranks [0, 1, 3]" in by_rank[2], by_rank[2]
    assert all(f"{dr.FORCED_TIMEOUTS[1]} s" in f for f in by_rank.values()), by_rank


@pytest.mark.parametrize("gs,key", SWEPT, ids=[f"{g[0]}x{g[1]}-{k}" for g, k in SWEPT])
def test_sweep_no_finding(results, gs, key):
    port, _ = results
    spawned = next(s for s, extra in SPAWNS.items() if gs == s or gs in extra)
    res = port[spawned]
    got = _one(res, "sweep", f"{gs[0]}x{gs[1]}/{key}")
    assert got["findings"] == [], got["findings"]
    assert any(r["sweep"][f"{gs[0]}x{gs[1]}/{key}"][k] for r in res
               for k in ("group", "p2p", "local")), key


def test_same_schedule_across_inputs_and_grids(results):
    """``assert_same_schedule`` of cholesky over two SPD inputs holds on
    every rank of 2x2 and of 2x3, and the two grids' schedules are the
    same (tests/test_collective_safety.py:161's intent)."""
    port, _ = results
    scheds = {gs: [r["same_inputs"] for r in res] for gs, res in port.items()}
    for gs, per_rank in scheds.items():
        assert all(s == per_rank[0] for s in per_rank), gs
        assert per_rank[0] == [(p, ax) for p, ax, _ in port[gs][0]["schedule"]]
        assert len(per_rank[0]) > 0
    assert scheds[(2, 2)][0] == scheds[(2, 3)][0]


def test_no_recorder_left_active(results):
    assert coll._recorder is None


def test_one_rank_records_local_calls():
    """Without a process group (the 1x1 grid) every call is local: it is
    recorded, the checker compares nothing and finds nothing."""
    grid = Grid((1, 1))
    x = torch.ones(3)

    def fn():
        coll.bcast(x, 0, COL_AXIS, grid)
        coll.allreduce_sum(x, ROW_AXIS, grid)
        coll.ring_shift(x, COL_AXIS, grid)
        coll.barrier()

    assert debug.check_collective_safety(fn) == []
    ops = debug.collective_schedule(fn)
    assert [op.prim for op in ops] == ["bcast", "allreduce_sum", "sendrecv", "barrier"]
    assert all(op.local for op in ops)
    assert ops[0].shape == (3,) and ops[0].dtype == "float32" and ops[0].owner == 0
    assert ops[0].path.startswith("test_torch_debug:fn:")
    assert coll._recorder is None


def test_complex_recorded_as_caller_dtype():
    grid = Grid((1, 1))
    ops = debug.collective_schedule(coll.allreduce_sum, torch.ones(2, dtype=torch.complex64),
                                    None, grid)
    assert ops[0].dtype == "complex64"


def test_prims_and_imports():
    """Every recorded prim has its JAX names; the module imports neither
    JAX nor the JAX package."""
    assert set(debug.JAX_PRIMS) == set(debug.COLLECTIVE_PRIMS)
    src = Path(debug.__file__).read_text()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] + [getattr(node, "module", None) or ""]
            assert not any(n == "jax" or n.startswith(("jax.", "dlaf_tpu."))
                           or n == "dlaf_tpu" for n in names), names
