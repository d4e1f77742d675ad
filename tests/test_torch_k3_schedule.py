"""K3's schedule without a grid barrier, on its Python twin.

csrc/band2tridiag.cu runs chase (s, c) on lane c // 3 at wavefront step
3s + c, and lane w starts step t once lanes w - 1 and w + 1 have finished
step t - 1; a block that holds several lanes takes them in increasing
order. ``ops/kernels/band2tridiag.py`` carries the same schedule in Python
(``lane_chase``, ``neighbour_schedule``, ``happens_before``). These tests
hold that schedule to the sequential chase: every chase runs once, every
two chases whose windows share an entry are ordered as in the sequential
chase by the happens-before relation the rule generates, and the plain
chase run in a random order the rule allows is bit-equal to
``band_to_tridiag_strips``, and, within the JAX test's tolerance
(tests/test_band_strips.py: tol(dtype, n, 2000) * max(1, max|A|)), to the
JAX package's strip chase. They also pin the launcher's choice of
instance, (dtype, b) -> resident or streamed, which the card's launch plan
is held to in chip_smoke.py and below.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlaf_tpu.algos.eigensolver import band_strips as jbs
from dlaf_tpu_torch.algos.eigensolver import band_strips as bs
from dlaf_tpu_torch.ops.kernels import band2tridiag as kb2t

from conftest import tol

# (n, b, blocks): lanes fewer than, equal to and more than the blocks
SCHEDULES = [(60, 8, 2), (97, 8, 1), (130, 16, 3), (200, 32, 8), (301, 8, 4), (50, 16, 100),
             (280, 8, 13)]
PAIRS = [(60, 8), (97, 8), (130, 16), (200, 32), (301, 8), (257, 64)]


def _sequential(n, b):
    return [(s, c) for s in range(n - 2) for c in range(-(-(n - 1 - s) // b))]


def _overlaps(n, b, chases):
    """(N, N) bool: whether chases i and j touch a common stored entry."""
    rect = np.array([kb2t.chase_cells(n, b, s, c) for s, c in chases])   # (N, 3, 4)
    a = rect[:, None, :, None, :]
    z = rect[None, :, None, :, :]
    r0 = np.maximum(a[..., 0], z[..., 0])
    r1 = np.minimum(a[..., 1], z[..., 1])
    c0 = np.maximum(a[..., 2], z[..., 2])
    c1 = np.minimum(a[..., 3], z[..., 3])
    meet = (r0 < r1) & (c0 < c1) & (r1 - 1 >= c0)    # a stored (row >= col) entry in common
    return meet.any(axis=(2, 3))


def _lane_step(chases):
    return np.array([(c // kb2t.LAG, kb2t.LAG * s + c) for s, c in chases])


@pytest.mark.parametrize("n,b,blocks", SCHEDULES)
def test_every_chase_runs_once(n, b, blocks):
    order = kb2t.neighbour_schedule(n, b, blocks, np.random.default_rng(n + blocks))
    ran = [chase for chase, _ in order]
    assert sorted(ran) == _sequential(n, b)
    for (s, c), (w, t) in order:
        assert kb2t.lane_chase(n, b, w, t) == (s, c)
        assert (w, t) == (c // kb2t.LAG, kb2t.LAG * s + c)
    assert kb2t.chase_lanes(n, b) == max(w for _, (w, _) in order) + 1


def test_happens_before_is_the_rule_closure():
    """The closed form equals reachability along the rule's edges
    (w', t - 1) -> (w, t), |w - w'| <= 1, on a small grid."""
    lanes, steps = 5, 9
    reach = {}
    for t in range(steps):
        for w in range(lanes):
            prev = set()
            if t > 0:
                for u in (w - 1, w, w + 1):
                    if 0 <= u < lanes:
                        prev |= reach[(u, t - 1)] | {(u, t - 1)}
            reach[(w, t)] = prev
    for (w, t), before in reach.items():
        for u in range(lanes):
            for r in range(steps):
                assert kb2t.happens_before((u, r), (w, t)) == ((u, r) in before)


@pytest.mark.parametrize("n,b", PAIRS)
def test_overlapping_chases_keep_the_sequential_order(n, b):
    chases = _sequential(n, b)
    meet = _overlaps(n, b, chases)
    earlier = np.triu(meet, 1)                   # chase i before chase j in the sequential order
    ls = _lane_step(chases)
    xi, yi = np.nonzero(earlier)
    assert xi.size > 0
    dw = np.abs(ls[xi, 0] - ls[yi, 0])
    dt = ls[yi, 1] - ls[xi, 1]
    assert np.all(dt > 0) and np.all(dw <= dt)   # happens_before for every overlapping pair
    assert all(kb2t.happens_before(tuple(ls[x]), tuple(ls[y])) for x, y in zip(xi[:500], yi[:500]))
    # the rule has teeth: some pair has its later chase on the lane below
    # (waiting on lane w - 1 alone would not order it), and some pair sits
    # at the rule's reach, |dw| = dt (a looser rule would not order it)
    assert np.any(ls[yi, 0] - ls[xi, 0] < 0)
    assert np.any(dw == dt)


@pytest.mark.parametrize("n,b,blocks", SCHEDULES)
def test_schedule_runs_overlapping_chases_in_sequential_order(n, b, blocks):
    """The simulated runs (lanes > blocks among them) start every chase
    after every overlapping chase that precedes it sequentially."""
    order = kb2t.neighbour_schedule(n, b, blocks, np.random.default_rng(7 * n + blocks))
    chases = _sequential(n, b)
    pos = {chase: i for i, (chase, _) in enumerate(order)}
    at = np.array([pos[chase] for chase in chases])
    xi, yi = np.nonzero(np.triu(_overlaps(n, b, chases), 1))
    assert np.all(at[xi] < at[yi])


def _band(n, b, dtype, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    if np.issubdtype(dtype, np.complexfloating):
        a = a + 1j * rng.standard_normal((n, n))
    a = a + a.conj().T
    i = np.arange(n)
    return np.where(np.abs(i[:, None] - i[None, :]) <= b, a, 0).astype(dtype)


def _chase_in(order, strips, n, b):
    strips = strips.clone()
    ncmax = -(-(n - 1) // b)
    vs = strips.new_zeros((n - 2, ncmax, b))
    taus = strips.new_zeros((n - 2, ncmax))
    for (s, c), _ in order:
        i0 = s + 1 + c * b
        g_, s3, im = bs._chase_window(strips, i0, b)
        g_new, v, tau = bs.chase_math(g_, c == 0, b)
        bs._chase_scatter(strips, g_new, s3, im, i0, b)
        vs[s, c], taus[s, c] = v, tau
    d, e = bs.strips_extract_tridiag(strips, n, b)
    return d, e, vs, taus


@pytest.mark.parametrize("n,b,blocks", [(70, 8, 2), (61, 16, 1), (90, 8, 5)])
@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_rule_order_is_bit_equal_to_the_sequential_chase(n, b, blocks, dtype):
    band = _band(n, b, dtype, seed=n + b)
    strips = bs.band_to_strips(torch.from_numpy(band), b)
    order = kb2t.neighbour_schedule(n, b, blocks, np.random.default_rng(3 * n + blocks))
    assert [chase for chase, _ in order] != _sequential(n, b)    # a real reordering
    got = _chase_in(order, strips, n, b)
    want = bs.band_to_tridiag_strips(strips, n, b)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    jd, je, _, jtaus = jbs.band_to_tridiag_strips(jbs.band_to_strips(jnp.asarray(band), b), n, b)
    bound = tol(np.dtype(dtype), n, 2000) * max(1.0, float(np.abs(band).max()))
    assert np.abs(got[0].numpy() - np.asarray(jd)).max() <= bound
    assert np.abs(got[1].numpy() - np.asarray(je)).max() <= bound
    assert np.abs(got[3].numpy() - np.asarray(jtaus)).max() <= bound


# the shared memory an H100's block may opt in to
# (cudaDevAttrMaxSharedMemoryPerBlockOptin), which the launcher reads there
H100_SMEM_OPTIN = 232448
# the (b, dtype) of chip_smoke.py's K3 cases, and the instance each takes on an H100
INSTANCES = [(128, torch.float32, "resident"), (128, torch.complex64, "streamed"),
             (16, torch.float32, "resident"), (160, torch.float32, "streamed"),
             (32, torch.float32, "resident"), (64, torch.complex64, "resident"),
             (8, torch.float32, "resident"), (10, torch.float32, "streamed"),
             (94, torch.complex64, "resident"), (96, torch.complex64, "streamed")]


@pytest.mark.parametrize("b,dtype,instance", INSTANCES)
def test_instance_rule(b, dtype, instance):
    assert kb2t.chase_instance(b, dtype, H100_SMEM_OPTIN) == instance
    fits = kb2t.resident_smem_bytes(b, dtype) <= H100_SMEM_OPTIN
    assert (instance == "resident") <= fits


@pytest.mark.parametrize("b,dtype", [(128, torch.float32), (64, torch.complex64)])
def test_instance_rule_follows_the_device_limit(b, dtype):
    """A device whose blocks may have fewer bytes than the window takes the
    streamed instance; one byte less than the window is enough."""
    need = kb2t.resident_smem_bytes(b, dtype)
    assert kb2t.chase_instance(b, dtype, need) == "resident"
    assert kb2t.chase_instance(b, dtype, need - 1) == "streamed"


def test_resident_bytes_follow_the_plan():
    """csrc resident_bytes: the 64-byte header, b rows [CY | S] and b rows
    B in floats (each rounded to 16-byte chunks after a 3-float shift and
    an overhang), v, w, q, p, and 3 x groups x b partial sums (groups =
    512 threads over b rounded up to whole warps); at b = 128 f32, rows of
    264 and 136 floats and 4 groups."""
    assert kb2t.resident_smem_bytes(128, torch.float32) == \
        64 + 128 * (264 + 136) * 4 + (4 * 128 + 3 * 4 * 128) * 4
    assert kb2t.resident_smem_bytes(94, torch.complex64) == \
        64 + 94 * (384 + 196) * 4 + (4 * 94 + 3 * 5 * 94) * 8
    for dtype, widest in ((torch.float32, 128), (torch.complex64, 94)):
        assert max(b for b in range(8, 385)
                   if kb2t.chase_instance(b, dtype, H100_SMEM_OPTIN) == "resident") == widest


@pytest.mark.parametrize("b,dtype,instance", INSTANCES)
def test_instance_rule_matches_the_launch_plan_cuda(b, dtype, instance):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the launch plan is the kernel library's")
    plan = kb2t.chase_plan(4 * b + 3, b, dtype)
    assert plan.instance == instance
    if instance == "resident":
        assert plan.smem_bytes == kb2t.resident_smem_bytes(b, dtype)
