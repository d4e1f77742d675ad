"""K4/K5's tensor-core arithmetic and zero rule on the CPU.

The kernels (``dlaf_tpu_torch/csrc/bt_apply.cu``) run each chase's two
products in three TF32 passes and multiply only the parts of V and V2 that
the staggered WY shape can make nonzero. Neither runs here, so:

  - the split's arithmetic, emulated by ``bt_apply_group_split_ref`` and
    ``bt_apply_fused_split_ref`` on numpy-seeded WY slabs made by
    ``bt._group_vt_all`` from random reflectors (exactly orthogonal blocks,
    so E keeps its scale), over chains of at least 64 chases at b = 32 and
    64: three terms stay within chip_smoke.py's K45_BOUND (64 eps32 max|E|)
    of the f64 plain version, one and two terms land far outside it;
  - the same three terms beside the JAX ``bt_apply_fused_pallas`` in
    interpret mode (its ``HIGHEST`` f32 products), both against f64, at the
    Pallas kernel's b = 128, tile 128, k = 2 and a few chases. Both land at
    f32's level; three TF32 terms sum more rounded parts than one f32
    product, and torch's CPU f32 product sums in another order than XLA's,
    so the split reads 1.2-1.25x the Pallas kernel's RMS distance from f64
    and 0.9-1.5x its largest (the port's plain f32 version alone reads
    1.2x its RMS): held to 1.5x the RMS and 2x the largest, the one- and
    two-term splits to 100x;
  - the zero rule's Python twin ``bt_apply_skip_rule``: every entry it
    leaves unmultiplied is exactly zero in ``_group_vt_all``'s V and V2, on
    random reflectors and on a raw record of the JAX chaser, for b in
    {32, 64, 128}, and everything multiplied is loaded.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlaf_tpu.algos.eigensolver.band2tridiag import band_to_tridiag as jax_dense_chase
from dlaf_tpu_torch.algos.eigensolver import bt as tbt
from dlaf_tpu_torch.ops.kernels import bt_apply as kbt

EPS32 = float(np.finfo(np.float32).eps)
K45_BOUND = 64.0        # chip_smoke.py: max|got - want| <= 64 eps32 max|E|


def _slabs(rng, nc, b):
    """(V, V2) of one group's nc chases from random exact reflectors (unit
    head, tau = 2 / v^T v), as stage 4 forms them."""
    vs = rng.standard_normal((b, nc, b)).astype(np.float32)
    vs[:, :, 0] = 1.0
    taus = (2.0 / (vs.astype(np.float64) ** 2).sum(-1)).astype(np.float32)
    return tbt._group_vt_all(torch.from_numpy(vs), torch.from_numpy(taus), 0, b, b, nc, None)


def _fused_slabs(rng, nsteps, k, b):
    pairs = [_slabs(rng, nsteps, b) for _ in range(k)]
    return (torch.stack([p[0] for p in pairs], 1).contiguous(),
            torch.stack([p[1] for p in pairs], 1).contiguous())


def _err(got, want, ep) -> float:
    """max|got - want| in units of eps32 max|E|, as chip_smoke.py's K45 checks."""
    return float(np.abs(np.asarray(got, np.float64) - np.asarray(want)).max()
                 / (EPS32 * float(np.abs(ep).max())))


def _rms(got, want, ep) -> float:
    d = np.asarray(got, np.float64) - np.asarray(want)
    return float(np.sqrt(np.mean(d * d)) / (EPS32 * float(np.abs(ep).max())))


# ----------------------------------------------- the split against K45_BOUND


@pytest.mark.parametrize("b", [32, 64])
@pytest.mark.parametrize("kind", ["K4", "K5"])
def test_three_tf32_terms_hold_the_k45_bound(b, kind):
    """A chain of 64 (K4) or 70 (K5: 4 groups, v0p = 16) chases over
    nev = 64 columns: three terms within K45_BOUND of the f64 plain
    version, one and two terms outside it."""
    rng = np.random.default_rng(b + (kind == "K5"))
    nev = 64
    if kind == "K4":
        nc = 64
        v, v2 = _slabs(rng, nc, b)
        args = (0, nc, b)
        ref, split = kbt.bt_apply_group_ref, kbt.bt_apply_group_split_ref
        nblk = nc + 2
    else:
        k, nact, v0p = 4, 4, 16
        nsteps = v0p + nact - 1
        v, v2 = _fused_slabs(rng, nsteps, k, b)
        args = (0, nact, v0p, k, b)
        ref, split = kbt.bt_apply_fused_ref, kbt.bt_apply_fused_split_ref
        nblk = nsteps + 2
    ep = torch.from_numpy(rng.standard_normal((nblk * b, nev)).astype(np.float32))
    want = ref(ep.double(), v.double(), v2.double(), *args).numpy()
    assert np.abs(want - ep.numpy()).max() > 0.5              # the chain moves E
    errs = {t: _err(split(ep.clone(), v, v2, *args, terms=t).numpy(), want, ep.numpy())
            for t in (1, 2, 3)}
    assert errs[3] <= K45_BOUND, errs
    assert errs[1] > K45_BOUND and errs[2] > K45_BOUND, errs


def test_split_ref_rejects_a_term_count():
    b = 32
    v = torch.zeros((1, 2 * b, b))
    with pytest.raises(ValueError):
        kbt.bt_apply_group_split_ref(torch.zeros((3 * b, 4)), v, v, 0, 1, b, terms=4)


# ------------------------------------- beside the Pallas kernel (interpret)


@pytest.fixture
def interpret():
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.mark.parametrize("beta,nact,v0p", [(1, 2, 3), (0, 2, 4), (1, 1, 4)])
def test_three_terms_land_at_the_pallas_kernels_level(interpret, beta, nact, v0p):
    from dlaf_tpu.ops.pallas.bt_apply import bt_apply_fused_pallas
    b, nev, k = 128, 128, 2
    rng = np.random.default_rng(10 * beta + nact + v0p)
    nsteps = v0p + nact - 1
    v, v2 = _fused_slabs(rng, nsteps + 1, k, b)
    ep = rng.standard_normal(((beta + nsteps + 2) * b, nev)).astype(np.float32)
    args = (beta, nact, v0p, k, b)
    want = kbt.bt_apply_fused_ref(torch.from_numpy(ep).double(), v.double(), v2.double(),
                                  *args).numpy()
    pallas = np.asarray(bt_apply_fused_pallas(jnp.asarray(ep), jnp.asarray(v.numpy()),
                                              jnp.asarray(v2.numpy()), *args, tile=128))
    split = {t: kbt.bt_apply_fused_split_ref(torch.from_numpy(ep.copy()), v, v2, *args,
                                             terms=t).numpy() for t in (1, 2, 3)}
    ref_err, ref_rms = _err(pallas, want, ep), _rms(pallas, want, ep)
    assert ref_err <= K45_BOUND
    assert _rms(split[3], want, ep) <= 1.5 * ref_rms
    assert _err(split[3], want, ep) <= 2 * ref_err
    for t in (1, 2):
        assert _err(split[t], want, ep) > 100 * ref_err


# ------------------------------------------------------------ the zero rule


def _band(n, b, seed):
    a = np.random.default_rng(seed).standard_normal((n, n))
    a = a + a.T
    i = np.arange(n)
    return np.where(np.abs(i[:, None] - i[None, :]) <= b, a, 0).astype(np.float32)


def _raw_record_slabs(b):
    """(V, V2) of the first group of a raw record (the JAX chaser's aliased
    layout: tau in slot 0 of every reflector, raw_bp = 128) of a random
    band, n = 4b."""
    n = 4 * b
    _, _, vs, taus = jax_dense_chase(jnp.asarray(_band(n, b, b)), b)
    vs, taus = np.array(vs), np.array(taus)
    nrec, ncmax = vs.shape[:2]
    raw = np.zeros((nrec + 1, ncmax, 128), np.float32)
    raw[:nrec, :, :b] = vs
    raw[:nrec, :, 0] = taus
    return tbt._group_vt_all(torch.from_numpy(raw), torch.from_numpy(taus), 0, b, b, ncmax, 128)


@pytest.mark.parametrize("b", [32, 64, 128])
@pytest.mark.parametrize("record", ["random", "raw"])
def test_skip_rule_drops_only_zeros(b, record):
    if record == "random":
        v, v2 = _slabs(np.random.default_rng(b), 6, b)
    else:
        v, v2 = _raw_record_slabs(b)
    rule = kbt.bt_apply_skip_rule(b)
    assert v.shape[1:] == v2.shape[1:] == rule["v_used"].shape == (2 * b, b)
    assert bool((v != 0).any()) and bool((v2 != 0).any())
    # never a nonzero outside what the kernel multiplies
    assert torch.equal(v[:, ~rule["v_used"]], torch.zeros_like(v[:, ~rule["v_used"]]))
    assert torch.equal(v2[:, ~rule["v2_used"]], torch.zeros_like(v2[:, ~rule["v2_used"]]))
    # what it multiplies, it loads
    for name in ("v", "v2"):
        assert not bool((rule[f"{name}_used"] & ~rule[f"{name}_loaded"]).any())


def test_skip_rule_saves_what_the_shape_allows():
    """At b = 128 the kernel multiplies 9/16 of V (the trapezoid is half of
    it) and 25/32 of V2 (three quarters), loads 5/8 of V: 344 of the 512
    (16-row tile, k8 step) fragments of a dense chase."""
    rule = kbt.bt_apply_skip_rule(128)
    frac = {k: float(m.float().mean()) for k, m in rule.items()}
    assert frac == {"v_used": 9 / 16, "v_loaded": 5 / 8, "v2_used": 25 / 32, "v2_loaded": 25 / 32}
    assert int(rule["v_used"].sum() + rule["v2_used"].sum()) // (16 * 8) == 344
