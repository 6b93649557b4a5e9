"""Each cell rehearsed on the CPU at a small size: its traffic, set-up,
window, metric readers, check and the result's shape. Every cell has a
rehearsal file, and a cell is added by files alone, one of a new
configuration included."""

import json
import pathlib
import shutil
import subprocess
import sys

import pytest

from port_bench.harness import Cell

from ._tiny import BENCH, REPO, cells, rehearsal, rehearsal_file, rehearse
from .test_bench_control import control_fails
from .test_bench_faults import fault_is_not_correct
from .test_bench_spans import spans_are_in_the_benchmark, spans_are_read

KEYS = ["correct", "attempted", "failed", "metrics", "device"]
NEW_CONFIGURATION = pathlib.Path(__file__).parent / "new_configuration"


def prints_the_contracts_line(cell, trace, bench=BENCH):
    result, checks = rehearse(cell, trace, bench=bench)
    assert list(result)[:5] == KEYS and list(result)[-1] == "checks"
    assert isinstance(result["correct"], bool) and result["attempted"] >= 1
    assert result["failed"] == 0
    assert result["device"]["platform"] == "cpu"  # a CPU run names no device metric
    wanted = {m["name"] for m in Cell(cell, bench).metrics(trace)}
    assert set(result["metrics"]) <= wanted
    if not trace:
        assert set(result["metrics"]) == wanted
    assert [k for k, _, _ in checks] == list(result["checks"])
    json.dumps(result)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", cells())
def test_a_rehearsal_prints_the_contracts_line(cell, trace):
    prints_the_contracts_line(cell, trace)


def test_every_cell_has_a_rehearsal_file():
    missing = [c for c in cells() if not rehearsal_file(c).is_file()]
    assert not missing, f"cells without port_bench/rehearsal/<cell>.json: {missing}"


ECHO_DRIVER = """
import time

import torch


class Echo:
    def __init__(self, cell, config, mix, device, seed, root):
        self.mix, self.extras = mix, {}

    def setup(self):
        self.x = torch.ones(int(self.mix["width"]))

    def window(self, seconds, profile_units=0):
        t0, n = time.perf_counter(), 0
        while time.perf_counter() - t0 < seconds:
            self.x = self.x * 1.0
            n += 1
        self.extras.update(window_s=time.perf_counter() - t0, attempted=n, failed=0)

    def end_to_end(self):
        return {"train_audio_s_per_s": self.extras["attempted"] / self.extras["window_s"]}

    def check(self, limits):
        return [("ones", float((self.x != 1).sum()), float(limits["ones"]))]


def control(cell, seed, device):
    return {"ones": float(cell.mix["width"])}, {}


Driver = Echo
"""


def _cell(entry, metric):
    """A ``workloads`` entry and the end-to-end metric whose cells it joins."""
    return {"configs": [], "workloads": [entry], "per_layer": [],
            "end_to_end": {metric: [entry["name"]]}}


def _rehearsal(base=None, **keys):
    r = {"config": {}, "mix": {}, **(rehearsal(base) if base else {}), **keys}
    return json.dumps(r)


def _serve_doc_b4():
    """A cell of an existing driver: a traffic file, a limits file and a
    rehearsal file."""
    mix = json.loads((REPO / "port_bench/traffic/serve-doc.json").read_text())
    mix.update(sentences_per_request=8, batch_size=4)
    limits = (REPO / "port_bench/limits/fastpitch-lj.serve-doc.json").read_text()
    files = {"traffic/serve-doc-b4.json": json.dumps(mix),
             "limits/fastpitch-lj.serve-doc-b4.json": limits,
             "rehearsal/fastpitch-lj.serve-doc-b4.json": _rehearsal(
                 "fastpitch-lj.serve-doc", host_metrics=[], device_metrics=[],
                 faults=["half_batch_vocoder"])}
    entry = {"name": "fastpitch-lj.serve-doc-b4", "config": "fastpitch-lj",
             "traffic": "serve-doc-b4", "chips": 1, "why": "a dummy"}
    return files, _cell(entry, "serve_audio_s_per_s")


def _echo():
    """A cell of a new driver: the driver's file, a traffic file naming it, a
    limits file and a rehearsal file."""
    files = {"drivers/echo.py": ECHO_DRIVER,
             "traffic/echo.json": json.dumps({"driver": "echo", "width": 8, "trace_units": 1}),
             "limits/hifigan-v1.echo.json": json.dumps({"limits": {"ones": 0}}),
             "rehearsal/hifigan-v1.echo.json": _rehearsal(host_metrics=[], device_metrics=[],
                                                          faults=[])}
    entry = {"name": "hifigan-v1.echo", "config": "hifigan-v1", "traffic": "echo", "chips": 1,
             "why": "a dummy"}
    return files, _cell(entry, "train_audio_s_per_s")


def _new_configuration():
    """A cell of a new configuration, the files of ``new_configuration/``:
    its configuration (top-level keys of its own), a driver with its
    control, a reference, counts, a traffic file, limits, a rehearsal file,
    a fault and the reader of a per-layer metric of the program's counter;
    and the entries of ``new_configuration/entries.json``."""
    files = {p.relative_to(NEW_CONFIGURATION).as_posix(): p.read_text()
             for p in NEW_CONFIGURATION.rglob("*") if p.is_file()
             and p.name != "entries.json" and "__pycache__" not in p.parts}
    return files, json.loads((NEW_CONFIGURATION / "entries.json").read_text())


def _tree(root):
    return {p.relative_to(root).as_posix(): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.mark.parametrize("case", [_serve_doc_b4, _echo, _new_configuration])
def test_a_cell_is_added_by_files(tmp_path, case):
    """A new cell: entries appended to ``BENCHMARK.json`` (a ``workloads``
    entry, its name appended to an end-to-end metric's cells, and for a new
    configuration its ``configs`` entry and a per-layer metric) and new
    files; no file the benchmark has changes. The new cell passes each
    check that every cell's parametrised tests make."""
    shutil.copytree(REPO / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    files, add = case()
    before = _tree(REPO / "port_bench")
    assert not set(files) & set(before)
    for name, text in files.items():
        (tmp_path / "port_bench" / name).write_text(text)
    bench = json.loads(BENCH.read_text())
    for key in ("configs", "workloads", "per_layer"):
        bench[key] += add[key]
    for m in bench["end_to_end"]:
        if m["name"] in add["end_to_end"]:
            m["workloads"] += add["end_to_end"][m["name"]]
    bench_file = tmp_path / "BENCHMARK.json"
    bench_file.write_text(json.dumps(bench))
    (cell,) = (w["name"] for w in add["workloads"])
    assert {m["name"] for m in Cell(cell, bench_file).metrics(False)} \
        == {*add["end_to_end"], "setup_s"}
    for trace in (False, True):
        prints_the_contracts_line(cell, trace, bench_file)
    control_fails(cell, bench_file)
    faults = rehearsal(cell, bench_file)["faults"]
    for fault in faults:
        fault_is_not_correct(cell, fault, bench_file)
    # calibrate.py finds the same faults (given no seeds, it runs nothing)
    out = subprocess.run([sys.executable, "port_bench/calibrate.py", "--workload", cell,
                          "--faults", ",".join(faults)], cwd=tmp_path, capture_output=True,
                         text=True)
    assert out.returncode == 0, out.stderr[-2000:]
    spans_are_in_the_benchmark(bench_file)
    spans_are_read(cell, bench_file)
    after = _tree(tmp_path / "port_bench")
    assert {k: v for k, v in after.items() if k not in files} == before
