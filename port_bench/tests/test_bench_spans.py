"""The readers of the program's own spans and counters
(``metrics/_spans.py`` and the metrics that use it), in the traced CPU
rehearsal of each cell: the host times and the counts read numbers, the
device times (CUDA events) read None; and a program that keeps no spans
gives no such metric and raises nothing. Which metric reads what is the
cell's rehearsal file's (``_tiny.py``)."""

import json

import pytest

from ._tiny import BENCH, cells, rehearsal, rehearse


def span_metrics(cell, bench=BENCH):
    r = rehearsal(cell, bench)
    return set(r["host_metrics"]) | set(r["device_metrics"])


def spans_are_in_the_benchmark(bench=BENCH):
    """Each span metric of a cell is a per-layer metric of the program's
    spans or counters, and of that cell alone."""
    per_layer = {m["name"]: m for m in json.loads(bench.read_text())["per_layer"]}
    for cell in cells(bench):
        for name in span_metrics(cell, bench):
            assert per_layer[name]["source"] in ("program_span", "program_counter"), name
            assert per_layer[name]["workloads"] == [cell], name


def spans_are_read(cell, bench=BENCH):
    from neuraltexttospeech_torch.utils import profiling

    profiling.reset()
    result, _ = rehearse(cell, trace=True, bench=bench)
    got, r = result["metrics"], rehearsal(cell, bench)
    for name in r["host_metrics"]:
        assert got[name]["value"] > 0, name
    for name in r.get("whole_metrics", []):
        assert got[name]["value"] == int(got[name]["value"]), name
    for name, inner in r.get("inner_metrics", {}).items():
        assert got[name]["value"] > sum(got[k]["value"] for k in inner), name
    assert not set(r["device_metrics"]) & set(got)  # no card: no device time


def test_every_span_metric_is_in_the_benchmark():
    spans_are_in_the_benchmark()


@pytest.mark.parametrize("cell", cells())
def test_traced_rehearsal_reads_the_programs_spans(cell):
    spans_are_read(cell)


@pytest.mark.parametrize("cell", cells())
def test_a_program_without_spans_gives_none(cell, monkeypatch):
    from neuraltexttospeech_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    result, _ = rehearse(cell, trace=True)
    assert not span_metrics(cell) & set(result["metrics"])
