"""Each cell rehearsed on the CPU at a small size: its traffic, set-up,
window, metric readers, check and the result's shape. A cell is added by
files alone."""

import json
import shutil

import pytest

from ._tiny import REPO, cells, rehearse

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", cells())
def test_a_rehearsal_prints_the_contracts_line(cell, trace):
    from port_bench.harness import Cell

    result, checks = rehearse(cell, trace)
    assert list(result)[:5] == KEYS and list(result)[-1] == "checks"
    assert isinstance(result["correct"], bool) and result["attempted"] >= 1
    assert result["failed"] == 0
    assert result["device"]["platform"] == "cpu"  # a CPU run names no device metric
    wanted = {m["name"] for m in Cell(cell, REPO / "BENCHMARK.json").metrics(trace)}
    assert set(result["metrics"]) <= wanted
    if not trace:
        assert set(result["metrics"]) == wanted
    assert [k for k, _, _ in checks] == list(result["checks"])
    json.dumps(result)


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


Driver = Echo
"""


def _serve_doc_b4():
    """A cell of an existing driver: a traffic file and a limits file."""
    mix = json.loads((REPO / "port_bench/traffic/serve-doc.json").read_text())
    mix.update(sentences_per_request=8, batch_size=4)
    limits = (REPO / "port_bench/limits/fastpitch-lj.serve-doc.json").read_text()
    files = {"traffic/serve-doc-b4.json": json.dumps(mix),
             "limits/fastpitch-lj.serve-doc-b4.json": limits}
    entry = {"name": "fastpitch-lj.serve-doc-b4", "config": "fastpitch-lj",
             "traffic": "serve-doc-b4", "chips": 1, "why": "a dummy"}
    return files, entry, "serve_audio_s_per_s"


def _echo():
    """A cell of a new driver: the driver's file, a traffic file naming it and
    a limits file."""
    files = {"drivers/echo.py": ECHO_DRIVER,
             "traffic/echo.json": json.dumps({"driver": "echo", "width": 8, "trace_units": 1}),
             "limits/hifigan-v1.echo.json": json.dumps({"limits": {"ones": 0}})}
    entry = {"name": "hifigan-v1.echo", "config": "hifigan-v1", "traffic": "echo", "chips": 1,
             "why": "a dummy"}
    return files, entry, "train_audio_s_per_s"


def _tree(root):
    return {p.relative_to(root).as_posix(): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.mark.parametrize("case", [_serve_doc_b4, _echo])
def test_a_cell_is_added_by_files(tmp_path, case):
    """A new cell: one workloads entry, one name appended to an end-to-end
    metric's cells, and new files; no file the benchmark has changes."""
    shutil.copytree(REPO / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    files, entry, metric = case()
    for name, text in files.items():
        (tmp_path / "port_bench" / name).write_text(text)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["workloads"].append(entry)
    for m in bench["end_to_end"]:
        if m["name"] == metric:
            m["workloads"].append(entry["name"])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    result, _ = rehearse(entry["name"], bench=tmp_path / "BENCHMARK.json")
    assert set(result["metrics"]) == {metric, "setup_s"}
    assert result["attempted"] >= 1
    before, after = _tree(REPO / "port_bench"), _tree(tmp_path / "port_bench")
    assert {k: v for k, v in after.items() if k not in files} == before
