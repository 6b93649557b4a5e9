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


def test_a_cell_is_added_by_files(tmp_path):
    """A new cell: one workloads entry, a traffic file and a limits file."""
    shutil.copytree(REPO / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    mix = json.loads((REPO / "port_bench/traffic/serve-doc.json").read_text())
    mix.update(sentences_per_request=8, batch_size=4)
    (tmp_path / "port_bench/traffic/serve-doc-b4.json").write_text(json.dumps(mix))
    limits = json.loads((REPO / "port_bench/limits/fastpitch-lj.serve-doc.json").read_text())
    (tmp_path / "port_bench/limits/fastpitch-lj.serve-doc-b4.json").write_text(json.dumps(limits))
    bench["workloads"].append({"name": "fastpitch-lj.serve-doc-b4", "config": "fastpitch-lj",
                               "traffic": "serve-doc-b4", "chips": 1, "why": "a dummy"})
    for m in bench["end_to_end"]:
        if m["name"] == "serve_audio_s_per_s":
            m["workloads"].append("fastpitch-lj.serve-doc-b4")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    result, _ = rehearse("fastpitch-lj.serve-doc-b4", bench=tmp_path / "BENCHMARK.json")
    assert set(result["metrics"]) == {"serve_audio_s_per_s", "setup_s"}
    assert result["attempted"] >= 1
