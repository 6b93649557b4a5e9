"""Small shapes for rehearsing the benchmark on the CPU, one file a cell:
``rehearsal/<cell>.json`` beside the cell's other files, found by the
cell's name. It holds

- ``config``: overrides of the configuration's file (a nested group's keys
  merge into the group), its widths cut so a run takes seconds;
- ``mix``: overrides of the traffic's file, cut to match;
- ``host_metrics``: the metrics of the program's spans and counters that the
  traced rehearsal reads as positive numbers, ``whole_metrics`` those of them
  that read whole numbers, and ``inner_metrics`` a span's metric with the
  metrics of the spans inside it, whose sum it exceeds (both may be absent);
- ``device_metrics``: the metrics of the program's spans timed on the
  device, which a run on the CPU leaves out;
- ``faults``: the faults (``planted/<name>.py``) that the cell's rehearsal
  has to find not ``correct``."""

from __future__ import annotations

import json
import pathlib
import time

import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
BENCH = REPO / "BENCHMARK.json"


def root(bench=BENCH) -> pathlib.Path:
    """The benchmark's directory beside ``bench``."""
    return pathlib.Path(bench).parent / "port_bench"


def rehearsal_file(cell: str, bench=BENCH) -> pathlib.Path:
    return root(bench) / "rehearsal" / f"{cell}.json"


def rehearsal(cell: str, bench=BENCH) -> dict:
    return json.loads(rehearsal_file(cell, bench).read_text())


def overrides(cell: str, bench=BENCH):
    """``(config overrides, mix overrides)`` of a cell's CPU rehearsal."""
    r = rehearsal(cell, bench)
    return r["config"], r["mix"]


def rehearse(cell: str, trace: bool = False, seconds: float = 0.5, seed: int = 2 ** 31 + 77,
             bench=BENCH):
    from port_bench.harness import run

    torch.manual_seed(0)
    cfg, mix = overrides(cell, bench)
    return run(cell, seed, seconds, trace, torch.device("cpu"), pathlib.Path(bench),
               time.time(), cfg, mix)


def cells(bench=BENCH):
    return [w["name"] for w in json.loads(pathlib.Path(bench).read_text())["workloads"]]
