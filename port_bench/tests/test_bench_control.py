"""The precision control -- the plain reference computed in fp8, put in the
program's place -- fails the cell's limits: on the CPU at a tiny size, and
on the card (marker ``card``) at a reduced size that a test run holds.  The
readings the limits were set from (a dozen seeds at the cells' own sizes,
``control.py``) are in PERF.md."""

import pytest
import torch

from port_bench.control import readings
from port_bench.core import compare, spec
from port_bench.tests.conftest import ROOT, tiny_serve, tiny_train

CELLS = [("res10-serve-b8", tiny_serve), ("res10-train-b32", tiny_train)]


def _fails(numbers: dict, limits: dict) -> bool:
    return not compare.passed(compare.judge(numbers, limits))


@pytest.mark.parametrize("cell,tiny", CELLS)
def test_control_fails_the_limits_on_the_cpu(cell, tiny):
    limits = spec.cell(spec.benchmark(ROOT), cell, ROOT)["workload"]["limits"]
    row, = readings(cell, [2 ** 31 + 11], 0.3, torch.device("cpu"), tiny(64))
    assert _fails(row["control"], limits)


@pytest.mark.card
@pytest.mark.parametrize("cell,tiny", CELLS)
def test_control_fails_the_limits_on_the_card(card_device, cell, tiny):
    limits = spec.cell(spec.benchmark(ROOT), cell, ROOT)["workload"]["limits"]
    small = tiny(320)
    small["mix"]["batch"] = 4 if "serve" in cell else 8
    for row in readings(cell, [101, 102, 103], 1.0, card_device, small):
        assert _fails(row["control"], limits)
