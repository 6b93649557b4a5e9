"""The control fails the cell's limits: the reference put in the program's
place one precision below the configuration's (bf16 → fp8 products for the
serving cells, f32 → TF32 products for the GAN step), at a small size on the
CPU. ``calibrate.py`` reads the same control on the card at the cell's own
size; its readings set the limits."""

import json

import pytest
import torch

from port_bench.calibrate import control_serving, control_training
from port_bench.harness import Cell

from ._tiny import REPO, cells, overrides


@pytest.mark.parametrize("cell", cells())
def test_the_control_fails_a_limit(cell):
    cfg, mix = overrides(cell)
    c = Cell(cell, REPO / "BENCHMARK.json", cfg, mix)
    control = control_serving if c.mix["driver"] == "serve" else control_training
    numbers = control(c, 2 ** 33 + 5, torch.device("cpu"))
    if isinstance(numbers, tuple):
        numbers = numbers[0]
    assert any(numbers[k] > c.limits[k] for k in numbers), json.dumps(numbers)
