"""The roofline counters against hand counts and entry-by-entry counts."""
import pytest

from portbench import roofline


def test_masked_update_keeps_part_of_a_tile():
    # a 2 x 2 tile on the diagonal, rank 1: the mask keeps (0,0), (1,0), (1,1)
    w = roofline.masked_update([0, 1], [0, 1], 1, lambda r, c: r >= c)
    assert w.flops == 2 * 1 * 3
    assert w.bytes == 4 * (2 * 3 + 1 * (2 + 2))


def test_cholesky_trailing_hand_count():
    # n = 4, nb = 2: one rank-2 update of the 2 x 2 trailing triangle (3 entries)
    w = roofline.cholesky_trailing(4, 2)
    assert w.flops == 2 * 2 * 3
    assert w.bytes == 4 * (2 * 3 + 2 * 2)


@pytest.mark.parametrize("n,nb", [(4, 2), (7, 2), (9, 3), (10, 4), (12, 5)])
def test_cholesky_trailing_entry_by_entry(n, nb):
    """The closed form equals the entries each step's mask keeps."""
    flops = 0
    for k0 in range(0, n, nb):
        w = min(nb, n - k0)
        rest = list(range(k0 + w, n))
        flops += roofline.masked_update(rest, rest, w, lambda r, c: r >= c).flops
    assert roofline.cholesky_trailing(n, nb).flops == flops


def test_cholesky_trailing_complex():
    real, cplx = roofline.cholesky_trailing(8, 2), roofline.cholesky_trailing(
        8, 2, elem_bytes=8, is_complex=True)
    assert cplx.flops == 4 * real.flops and cplx.bytes == 2 * real.bytes


def test_band_chase_hand_count():
    # n = 4, b = 2: sweep 0 chases at i0 = 1 (l 2, r 1) and 3 (l 1, bulge
    # 1 column), sweep 1 at i0 = 2 (l 2, r 0)
    w = roofline.band_chase(4, 2)
    assert w.flops == 2 * ((2 * 4 + 2 * 1 * 2) + (2 * 1 + 2 * 1 * 1) + 2 * 4)
    assert w.bytes == 4 * (2 * 4 * 3 + (3 + 2 + 3))


def test_least_time_and_bound():
    w = roofline.Work(flops=roofline.PEAK_FLOPS, bytes=0)
    assert w.least_s() == 1.0 and w.bound() == "compute"
    m = roofline.Work(flops=0, bytes=2 * roofline.PEAK_BYTES)
    assert m.least_s() == 2.0 and m.bound() == "memory"


def test_cell_counts_are_compute_bound():
    """At the cells' sizes the counts are bound by the TF32 rate (the
    figures PERF.md quotes)."""
    w = roofline.cholesky_trailing(40960, 512)
    assert w.bound() == "compute"
    assert w.least_s() == pytest.approx(45.41e-3, rel=1e-3)
    assert roofline.band_chase(10240, 128).least_s() == pytest.approx(0.1593e-3, rel=1e-3)
