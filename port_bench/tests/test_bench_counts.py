"""The work counts against hand-worked site shapes and res10's totals
(PERF.md's K1 / K4 / K5 bounds of the older chip runs)."""

import json
import math

import pytest

from port_bench import counts
from port_bench.tests.conftest import ROOT


@pytest.fixture(scope="module")
def res10():
    cfg = json.loads((ROOT / "port_bench/configs/ems-res10-ecs.json").read_text())
    return cfg, counts.model_shapes(cfg, 640)


def test_site_table(res10):
    _, shapes = res10
    assert counts.site_table(shapes) == [
        [320, 320, 64, True, 1], [160, 160, 64, False, 4], [80, 80, 128, False, 3],
        [40, 40, 384, False, 2], [40, 40, 256, False, 4], [20, 20, 1024, False, 1],
        [20, 20, 512, False, 4], [20, 20, 256, False, 4], [20, 20, 128, False, 1]]


def test_one_site_by_hand():
    """K1 at 80x80x128, T=4, N=8, bf16: bytes (4 + 4) * 8 * 80 * 80 * 128 + 11 * 128
    + 128^2 elements of 2 bytes; 3 * 8 * 6400 * (2 * 128^2 + 18 * 128) operations."""
    shapes = {"sites": [(80, 80, 128, False)]}
    nbytes = (8 * 8 * 80 * 80 * 128 + 11 * 128 + 128 * 128) * 2
    flops = 3 * 8 * 6400 * (2 * 128 * 128 + 18 * 128)
    want = max(nbytes / 3.35e12, flops / 989e12)
    assert counts.k1_bound_s(shapes, 4, 8, "bfloat16") == pytest.approx(want, rel=1e-12)
    # K4 and K5 at one launch each (T=2 gives T-1 = 1 launch)
    p = 8 * 80 * 80 * 128
    k4 = counts.spread_bounds(shapes, 2, 8, "bfloat16")["k4"]
    assert k4 == {"launches": 1, "bound_s": pytest.approx(
        max((p * 5 + 10 * 128 * 2) / 3.35e12, 18 * p / 989e12))}
    k5 = counts.spread_bounds({"sites": [(160, 160, 64, False)]}, 2, 8, "bfloat16")["k5"]
    p = 8 * 160 * 160 * 64
    assert k5["bound_s"] == pytest.approx(max(
        (p * 3 + 9 * 64 * 64 * 2 + 4 * 64) / 3.35e12, 2 * 9 * 64 * 64 * 8 * 160 * 160 / 989e12))


def test_res10_totals(res10):
    cfg, shapes = res10
    # PERF.md: K1 0.681 ms over one b8 forward; K4 0.2514 ms and K5 0.366 ms over
    # one b8 training forward (57 and 15 launches)
    assert counts.k1_bound_s(shapes, 4, 8, "bfloat16") * 1e3 == pytest.approx(0.681, abs=5e-4)
    b = counts.spread_bounds(shapes, 4, 8, "bfloat16")
    assert b["k4"]["launches"] == 57 and b["k5"]["launches"] == 15
    assert b["k4"]["bound_s"] * 1e3 == pytest.approx(0.2514, abs=5e-4)
    assert b["k5"]["bound_s"] * 1e3 == pytest.approx(0.366, abs=5e-4)
    # the stem at T=1: 2 * 49 * 3 * 64 * 320 * 320 operations an image
    stem = 2 * 49 * 3 * 64 * 320 * 320
    assert shapes["conv_flops"] > stem
    assert counts.forward_flops(shapes) / 1e9 == pytest.approx(128.886, abs=1e-3)
    assert math.isclose(shapes["site_flops"], sum(
        3 * h * w * (2 * c * c + 18 * c) for h, w, c, _ in shapes["sites"]))
