"""On the card: the control is rejected by each cell's check, and a short
run of a cell is correct and reads its metrics. Run on a machine with the
H100: ``python -m pytest -c /dev/null --rootdir . portbench/tests -m card``."""
import time

import pytest

from portbench import control, harness, spec

SEED = 2**31 + 101


@pytest.mark.card
@pytest.mark.parametrize("cell,n", [("cholesky-f32.n40960", 8192), ("cholesky-f32.n10240", 8192),
                                    ("cholesky-f32.pspotrf-n20480", 8192),
                                    ("eigensolver-f32.n10240", None)])
def test_control_is_rejected(card, cell, n):
    """TF32 products in the program's place fail the cell's own limits (the
    eigensolver at its own size: its control's margin is the narrowest)."""
    (row,) = control.readings(cell, [SEED], n)
    assert row["rejected"], row


@pytest.mark.card
def test_short_traced_run(card):
    cell = "cholesky-f32.n10240"
    r = harness.run(cell, SEED + 1, 2.0, True, time.perf_counter())
    assert r["correct"] and r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    m = r["metrics"]
    assert set(m) == set(spec.load_workload(cell)["per_layer"])
    assert 0 < m["k6_roofline.host"]["value"] <= 100
    assert 0 <= m["device_idle_share.host"]["value"] < 100
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
