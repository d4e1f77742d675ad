"""Kernels K4/K5 (the streaming stage-4 apply) and the shifted and raw-record
branches of the port's bt_band_to_tridiag against the JAX package.

The same numpy inputs go through both packages:
  - the plain versions of K4 and K5 against the Pallas kernels
    bt_apply_group_pallas / bt_apply_fused_pallas themselves, run in
    interpret mode as tests/test_band_strips.py runs them, at b = 128;
  - the port's bt_band_to_tridiag(shifted=True) (K4/K5's plain versions on
    the CPU) against the JAX package's cooked grouped apply, on cooked and
    raw records, single-chunk and the three-chunk plan whose last chunk
    overshoots the band end (the abs0 clamp and phantom groups);
  - the raw-record (raw_bp) grouped apply against the JAX one.
Tolerance: 1e-5 absolute on O(1) inputs, as tests/test_band_strips.py uses
for the same comparisons; the random slabs of the kernel cases are not
orthogonal and let E grow, so there it is 1e-5 times max(1, max|E|).
The CUDA cases skip here: the kernels run only on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dlaf_tpu
import dlaf_tpu_torch as dtt
from dlaf_tpu.algos.eigensolver import bt as jbt
from dlaf_tpu.algos.eigensolver.band2tridiag import band_to_tridiag as jax_dense_chase
from dlaf_tpu_torch.algos.eigensolver import bt as tbt
from dlaf_tpu_torch.ops.kernels import _build
from dlaf_tpu_torch.ops.kernels import bt_apply as kbt

ATOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _slabs(rng, shape):
    """V/V2-like slabs scaled so a chase keeps E at O(1)."""
    return (rng.standard_normal(shape) / np.sqrt(2 * shape[-1])).astype(np.float32)


def _band(n, b, seed=0):
    a = _rng(seed).standard_normal((n, n))
    a = a + a.T
    i = np.arange(n)
    return np.where(np.abs(i[:, None] - i[None, :]) <= b, a, 0).astype(np.float32)


@pytest.fixture
def interpret():
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.fixture
def fuse(request):
    """Both packages' bt_apply_fuse_groups set to request.param."""
    dlaf_tpu.set_tune_parameters(bt_apply_fuse_groups=request.param)
    dtt.set_tune_parameters(bt_apply_fuse_groups=request.param)
    yield request.param
    dlaf_tpu.tune.reset_tune_parameters()
    dtt.reset_tune_parameters()


# ------------------------------------------- K4/K5 plain vs Pallas (interpret)


@pytest.mark.parametrize("nev", [128, 256])
@pytest.mark.parametrize("base", [0, 1])
def test_group_plain_matches_pallas(interpret, nev, base):
    from dlaf_tpu.ops.pallas.bt_apply import bt_apply_group_pallas
    b, ncmax, ncvalid, nblk = 128, 3, 2, 5
    rng = _rng(10 * nev + base)
    ep = rng.standard_normal((nblk * b, nev)).astype(np.float32)
    v, v2 = _slabs(rng, (ncmax, 2 * b, b)), _slabs(rng, (ncmax, 2 * b, b))
    want = np.asarray(bt_apply_group_pallas(jnp.asarray(ep), jnp.asarray(v), jnp.asarray(v2),
                                            base, ncvalid, b, tile=128))
    got = kbt.bt_apply_group(torch.from_numpy(ep.copy()), torch.from_numpy(v),
                             torch.from_numpy(v2), base, ncvalid, b)
    assert np.abs(want - ep).max() > 0.1
    assert np.abs(got.numpy() - want).max() <= ATOL * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("k,nact", [(2, 2), (2, 1), (4, 4), (4, 3)])
def test_fused_plain_matches_pallas(interpret, k, nact):
    from dlaf_tpu.ops.pallas.bt_apply import bt_apply_fused_pallas
    b, nev, beta, v0p = 128, 128, 1, 2
    nsteps = v0p + nact - 1
    nblk = beta + nsteps + 2
    rng = _rng(100 * k + nact)
    ep = rng.standard_normal((nblk * b, nev)).astype(np.float32)
    v, v2 = (_slabs(rng, (nsteps + 1, k, 2 * b, b)) for _ in range(2))
    want = np.asarray(bt_apply_fused_pallas(jnp.asarray(ep), jnp.asarray(v), jnp.asarray(v2),
                                            beta, nact, v0p, k, b, tile=128))
    got = kbt.bt_apply_fused(torch.from_numpy(ep.copy()), torch.from_numpy(v),
                             torch.from_numpy(v2), beta, nact, v0p, k, b)
    assert np.abs(want - ep).max() > 0.1
    assert np.abs(got.numpy() - want).max() <= ATOL * max(1.0, np.abs(want).max())


def test_fused_plain_without_active_groups_is_a_no_op():
    b, k = 128, 4
    rng = _rng(7)
    ep = torch.from_numpy(rng.standard_normal((4 * b, 64)).astype(np.float32))
    v = torch.from_numpy(_slabs(rng, (3, k, 2 * b, b)))
    got = kbt.bt_apply_fused(ep.clone(), v, v, 1, 0, 3, k, b)
    assert torch.equal(got, ep)


def test_fused_plain_is_k4_at_k1():
    """K4 is K5 with one group: nact = 1, beta = base, v0p = ncvalid."""
    b, nev, base, ncvalid = 16, 40, 2, 5
    rng = _rng(3)
    ep = torch.from_numpy(rng.standard_normal(((base + ncvalid + 2) * b, nev)).astype(np.float32))
    v, v2 = (torch.from_numpy(_slabs(rng, (ncvalid, 2 * b, b))) for _ in range(2))
    k4 = kbt.bt_apply_group(ep.clone(), v, v2, base, ncvalid, b)
    k5 = kbt.bt_apply_fused(ep.clone(), v[:, None], v2[:, None], base, 1, ncvalid, 1, b)
    assert torch.equal(k4, k5)


# ---------------------------------------------------- the Hopper plan model


def test_fused_groups_and_feasibility_follow_the_shared_memory_plan():
    # k + 1 E blocks of b x 32 f32, Y split (two blocks' room) and a ring
    # of 3 chunks of 32 x b f32 within 227 KB a block
    assert kbt._smem_bytes(8, 128) == (11 * 128 * 32 + 3 * 32 * 128) * 4 <= kbt.SMEM_LIMIT
    assert kbt.fused_groups(32768, 128) == 8
    assert kbt.fused_groups(100, 128) == 8          # nev does not enter
    assert kbt.fused_groups(32768, 160) == 4        # 7 blocks of 20 KB and the ring fit, 11 do not
    assert kbt.fused_groups(32768, 192) == 2        # 5 blocks of 24 KB and the ring fit
    assert kbt.fused_groups(32768, 128, k_max=2) == 2
    assert kbt.fused_groups(32768, 32) == 8
    for b in (32, 64, 128, 192):
        assert kbt.bt_apply_feasible(b, torch.float32)
    for b, dt in ((120, torch.float32), (16, torch.float32), (224, torch.float32),
                  (256, torch.float32), (128, torch.float64), (128, torch.complex64)):
        assert not kbt.bt_apply_feasible(b, dt)


@pytest.fixture
def fake_cuda(monkeypatch):
    """Route CPU tensors as if they were on the card, so that the wrappers'
    checks run; every case below raises before it could launch."""
    monkeypatch.setattr(_build, "on_cuda", lambda t: True)


@pytest.mark.parametrize("case", ["dtype", "band", "v_shape", "beyond", "nact"])
def test_cuda_wrappers_refuse_what_the_kernel_does_not_take(fake_cuda, case):
    b, nev = 32, 40
    ep = torch.zeros((6 * b, nev))
    v = torch.zeros((3, 2 * b, b))
    vf = torch.zeros((3, 2, 2 * b, b))
    with pytest.raises(ValueError):
        if case == "dtype":
            kbt.bt_apply_group(ep.double(), v.double(), v.double(), 0, 2, b)
        elif case == "band":
            kbt.bt_apply_group(torch.zeros((6 * 48, nev)), torch.zeros((3, 96, 48)),
                               torch.zeros((3, 96, 48)), 0, 2, 48)
        elif case == "v_shape":
            kbt.bt_apply_fused(ep, v, v, 0, 2, 2, 2, b)
        elif case == "beyond":
            kbt.bt_apply_group(ep, v, v, 4, 3, b)           # block 7 of 6
        else:
            kbt.bt_apply_fused(ep, vf, vf, 0, 3, 1, 2, b)   # nact > k


@pytest.mark.parametrize("case", ["ncvalid0", "nact0", "nev0"])
def test_cuda_wrappers_launch_nothing_without_a_chase(fake_cuda, monkeypatch, case):
    """No chase to run: the wrapper returns the buffer untouched, loads no
    kernel library and leaves the launch counts as they were."""
    def no_library(name):
        raise AssertionError(f"{name} loaded for a call with no chase")
    monkeypatch.setattr(_build, "library", no_library)
    b = 32
    nev = 0 if case == "nev0" else 40
    ep = torch.randn((6 * b, nev))
    want = ep.clone()
    before = (kbt.bt_apply_group.launches, kbt.bt_apply_fused.launches)
    if case == "ncvalid0":
        got = kbt.bt_apply_group(ep, torch.zeros((0, 2 * b, b)), torch.zeros((0, 2 * b, b)),
                                 2, 0, b)
    else:
        vf = torch.zeros((3, 2, 2 * b, b))
        got = kbt.bt_apply_fused(ep, vf, vf, 1, 0 if case == "nact0" else 2, 2, 2, b)
    assert got is ep and torch.equal(got, want)
    assert (kbt.bt_apply_group.launches, kbt.bt_apply_fused.launches) == before


def test_plain_versions_do_not_count_launches():
    b = 16
    before = (kbt.bt_apply_group.launches, kbt.bt_apply_fused.launches)
    ep = torch.zeros((4 * b, 8))
    kbt.bt_apply_group(ep, torch.zeros((1, 2 * b, b)), torch.zeros((1, 2 * b, b)), 0, 1, b)
    kbt.bt_apply_fused(ep, torch.zeros((1, 2, 2 * b, b)), torch.zeros((1, 2, 2 * b, b)),
                       0, 1, 1, 2, b)
    assert (kbt.bt_apply_group.launches, kbt.bt_apply_fused.launches) == before


# ------------------------------------------------- the WY slabs and stage 4


def _record(n, b, seed=0):
    """A cooked stage-2 record (numpy) of a random band, from the JAX chase."""
    _, _, vs, taus = jax_dense_chase(jnp.asarray(_band(n, b, seed)), b)
    return np.asarray(vs), np.asarray(taus)


def _raw(vs, taus, lo, chunk, ncmax, b, junk=True):
    """The JAX chaser's raw record of sweeps [lo, lo + chunk), synthesized
    from a cooked one (tests/test_band_strips.py:244-258), with tau in
    slot 0 of every reflector as the chaser leaves it."""
    raw = np.zeros((chunk + 1, ncmax, 128), np.float32)
    tch = np.zeros((chunk, ncmax), np.float32)
    nvalid = max(0, min(chunk, vs.shape[0] - lo))
    raw[:nvalid, :, :b] = vs[lo:lo + nvalid]
    tch[:nvalid] = taus[lo:lo + nvalid]
    if junk:
        raw[:nvalid, :, 0] = tch[:nvalid]
    return raw, tch


def test_group_vt_all_matches_jax():
    n, b = 256, 128
    vs, taus = _record(n, b)
    ncmax = vs.shape[1]
    raw, tch = _raw(vs, taus, 0, 256, ncmax, b)
    sel = jbt.wy_select_tensor(b, b, jnp.float32)
    for s0 in (0, 128):
        v0, v20 = (np.asarray(x) for x in jbt._group_vt_all(
            jnp.asarray(raw), jnp.asarray(tch), jnp.int32(s0), b, b, 128, ncmax, sel))
        v1, v21 = tbt._group_vt_all(torch.from_numpy(raw), torch.from_numpy(tch), s0, b, b,
                                    ncmax, 128)
        assert v1.shape == v0.shape and v21.shape == v20.shape
        assert np.abs(v1.numpy() - v0).max() <= ATOL
        assert np.abs(v21.numpy() - v20).max() <= ATOL


def _cooked_jax(e_mat, vs, taus, b):
    return np.asarray(jbt.bt_band_to_tridiag(jnp.asarray(e_mat), jnp.asarray(vs),
                                             jnp.asarray(taus), b, group_size=b))


def _shifted(e_mat, b):
    n, nev = e_mat.shape
    ep2 = torch.zeros((n + 2 * b, nev))
    ep2[:n - 1] = torch.from_numpy(e_mat[1:])
    return ep2


def _unshift(e_mat, ep2):
    return np.concatenate([e_mat[:1], ep2[:e_mat.shape[0] - 1].numpy()])


@pytest.mark.parametrize("fuse", [8], indirect=True)
@pytest.mark.parametrize("layout", ["cooked", "raw"])
def test_shifted_apply_matches_jax_cooked(fuse, layout):
    n, b, nev = 256, 128, 256
    vs, taus = _record(n, b)
    e_mat = _rng(3).standard_normal((n, nev)).astype(np.float32)
    want = _cooked_jax(e_mat, vs, taus, b)
    ep2 = _shifted(e_mat, b)
    if layout == "cooked":
        out = tbt.bt_band_to_tridiag(ep2, torch.from_numpy(vs), torch.from_numpy(taus), b,
                                     group_size=b, shifted=True)
    else:
        raw, tch = _raw(vs, taus, 0, 256, vs.shape[1], b)
        out = tbt.bt_band_to_tridiag(ep2, torch.from_numpy(raw), torch.from_numpy(tch), b,
                                     group_size=b, raw_bp=128, shifted=True)
    assert out is ep2                                    # in place
    assert np.abs(_unshift(e_mat, ep2) - want).max() <= ATOL


@pytest.mark.parametrize("fuse", [2, 8], indirect=True)
def test_shifted_three_chunk_plan_matches_jax_cooked(fuse):
    """n = 896, b = 128, rec_chunks = 3: chunk 384 covers 1152 sweeps, 258 =
    2b + 2 past the last one, so the last chunk's top group is clamped
    (abs0) and its fused step holds a phantom group."""
    n, b, nev = 896, 128, 128
    chunk, nchunks = 384, 3
    vs, taus = _record(n, b)
    e_mat = _rng(4).standard_normal((n, nev)).astype(np.float32)
    want = _cooked_jax(e_mat, vs, taus, b)
    ep2 = _shifted(e_mat, b)
    for ci in range(nchunks - 1, -1, -1):
        raw, tch = _raw(vs, taus, ci * chunk, chunk, vs.shape[1], b)
        tbt.bt_band_to_tridiag(ep2, torch.from_numpy(raw), torch.from_numpy(tch), b,
                               group_size=b, sweep_lo=ci * chunk, raw_bp=128, shifted=True)
    assert np.abs(_unshift(e_mat, ep2) - want).max() <= ATOL


@pytest.mark.parametrize("fuse", [4, 8], indirect=True)
def test_shifted_peel_and_fused_steps_match_jax_cooked(fuse, monkeypatch):
    """15 groups of b = 32: fuse 8 peels 7 groups through K4 and runs one
    fused step of 8; fuse 4 peels 3 and runs three steps of 4."""
    n, b, nev = 480, 32, 48
    vs, taus = _record(n, b)
    calls = {"group": 0, "fused": 0}
    for name, key in (("bt_apply_group", "group"), ("bt_apply_fused", "fused")):
        real = getattr(tbt, name)

        def spy(*a, _real=real, _key=key):
            calls[_key] += 1
            return _real(*a)
        monkeypatch.setattr(tbt, name, spy)
    e_mat = _rng(5).standard_normal((n, nev)).astype(np.float32)
    want = _cooked_jax(e_mat, vs, taus, b)
    ep2 = _shifted(e_mat, b)
    tbt.bt_band_to_tridiag(ep2, torch.from_numpy(vs), torch.from_numpy(taus), b,
                           group_size=b, shifted=True)
    assert calls == ({"group": 7, "fused": 1} if fuse == 8 else {"group": 3, "fused": 3})
    assert np.abs(_unshift(e_mat, ep2) - want).max() <= ATOL


def test_shifted_apply_refuses_what_it_cannot_take():
    vs = torch.zeros((6, 2, 32))
    taus = torch.zeros((6, 2))
    with pytest.raises(ValueError):      # group size != band
        tbt.bt_band_to_tridiag(torch.zeros((96, 4)), vs, taus, 32, group_size=16, shifted=True)
    with pytest.raises(ValueError):      # f64
        tbt.bt_band_to_tridiag(torch.zeros((96, 4), dtype=torch.float64), vs.double(),
                               taus.double(), 32, group_size=32, shifted=True)


def test_raw_record_grouped_apply_matches_jax():
    """The raw_bp branch without the shift (tests/test_band_strips.py:81-105):
    n = 66, b = 8, group 16, prepadded."""
    n, b, g, nev = 66, 8, 16, 24
    vs, taus = _record(n, b, seed=1)
    raw, tch = _raw(vs, taus, 0, n - 2, vs.shape[1], b)
    e_mat = _rng(6).standard_normal((n, nev)).astype(np.float32)
    ep = np.concatenate([e_mat, np.zeros((b + g - 1, nev), np.float32)])
    want = np.asarray(jbt.bt_band_to_tridiag(jnp.asarray(ep), jnp.asarray(raw), jnp.asarray(tch),
                                             b, group_size=g, prepadded=True, raw_bp=128))
    got = tbt.bt_band_to_tridiag(torch.from_numpy(ep.copy()), torch.from_numpy(raw),
                                 torch.from_numpy(tch), b, group_size=g, prepadded=True,
                                 raw_bp=128)
    assert np.abs(got.numpy() - want).max() <= ATOL
    cooked = _cooked_jax(e_mat, vs, taus, b)
    assert np.abs(got.numpy()[:n] - cooked).max() <= ATOL
    with pytest.raises(ValueError):       # sweeps not a multiple of the group
        tbt.bt_band_to_tridiag(torch.from_numpy(ep.copy()), torch.from_numpy(raw[2:]),
                               torch.from_numpy(tch[2:]), b, group_size=g, prepadded=True,
                               raw_bp=128)


# ------------------------------------------------------- on the card only


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels run only on the card")


@pytest.mark.parametrize("k,nact", [(1, 1), (8, 8), (8, 5), (2, 0)])
def test_bt_apply_kernels_cuda(k, nact):
    """The kernels against their plain versions on random slabs of the WY
    shape (the kernels take the entries outside it as zero)."""
    _need_cuda()
    b, nev, beta, v0p = 128, 1000, 1, 4
    nsteps = v0p + nact - 1 if nact else 0
    g = torch.Generator(device="cuda").manual_seed(k + nact)
    ep = torch.randn(((beta + nsteps + 2) * b, nev), device="cuda", generator=g)
    rule = kbt.bt_apply_skip_rule(b)
    v, v2 = (torch.randn((nsteps + 1, k, 2 * b, b), device="cuda", generator=g) / 16
             * rule[name].to("cuda") for name in ("v_used", "v2_used"))
    want = kbt.bt_apply_fused_ref(ep.clone(), v, v2, beta, nact, v0p, k, b)
    if k == 1:
        got = kbt.bt_apply_group(ep.clone(), v[:, 0], v2[:, 0], beta, v0p, b)
    else:
        got = kbt.bt_apply_fused(ep.clone(), v, v2, beta, nact, v0p, k, b)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 64 * 1.2e-7 * float(ep.abs().max()) * 16
