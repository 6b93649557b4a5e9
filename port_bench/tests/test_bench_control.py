"""The control fails the cell's limits: the reference put in the program's
place one precision below the configuration's (bf16 → fp8 products for the
serving cells and FastPitch training, f32 → TF32 products for the GAN step),
at a small size on the CPU; a cell's control is its driver's
(``drivers/<driver>.py::control``). ``calibrate.py`` reads the same control on the
card at the cell's own size; its readings set the limits."""

import json

import pytest
import torch

from port_bench.calibrate import load_control
from port_bench.harness import Cell

from ._tiny import BENCH, cells, overrides


def control_fails(cell, bench=BENCH):
    cfg, mix = overrides(cell, bench)
    c = Cell(cell, bench, cfg, mix)
    numbers, _ = load_control(c)(c, 2 ** 33 + 5, torch.device("cpu"))
    assert any(numbers[k] > c.limits[k] for k in numbers), json.dumps(numbers)


@pytest.mark.parametrize("cell", cells())
def test_the_control_fails_a_limit(cell):
    control_fails(cell)
