"""A serving traffic file's ``duration_log_std`` sets the spread of the
served log-durations in place of the configuration's, in the driver and in
its control alike."""

import pytest
import torch

from port_bench.harness import Cell
from port_bench.reference import load_by_path
from port_bench.yardstick import traffic, weights

from ._tiny import REPO, overrides


@pytest.mark.parametrize("cell", ["fastpitch-lj.serve-single", "fastpitch-lj.serve-doc"])
def test_a_serving_traffic_sets_the_spread_of_durations(cell):
    cfg, mix = overrides(cell)
    c = Cell(cell, REPO / "BENCHMARK.json", cfg, mix)
    serve = load_by_path(c.root / "drivers" / "serve.py", "port_bench.drivers").Driver(
        c.cell, c.config, c.mix, torch.device("cpu"), 2 ** 33 + 9, c.root)
    want = c.mix.get("duration_log_std", c.config["init"]["duration_log_std"])
    assert serve.cfg["init"]["duration_log_std"] == want
    nets = serve.ref.build(serve.cfg, torch.device("cpu"))
    leaves = sorted((f"{k}.{n}", s) for k, net in nets.items() for n, s in weights.spec(net))
    w = serve.init_weights(serve.cfg, leaves, 2 ** 33 + 9, torch.device("cpu"))
    texts = traffic.Sentences(c.mix, 0, c.root).middles()
    mean, std = serve.ref.log_duration_stats(serve.cfg, w, torch.device("cpu"), texts)
    assert std == pytest.approx(want, rel=1e-3)
    assert mean == pytest.approx(serve.cfg["init"]["duration_bias"], abs=1e-3)
