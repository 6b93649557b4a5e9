"""The readers of the program's own spans and counters
(``metrics/_spans.py`` and the metrics that use it), in the traced CPU
rehearsal of each cell: the host times and the counts read numbers, the
device times (CUDA events) read None; and a program that keeps no spans
gives no such metric and raises nothing."""

import pytest

from ._tiny import REPO, cells, rehearse

HOST = {"fastpitch-lj.serve-doc": set(),
        "fastpitch-lj.serve-single": {"encode_ms.single", "issue_ms.single",
                                      "casts_per_request.single"},
        "hifigan-v1.train": {"gan_step_ms.train", "gan_backward_ms.train", "gan_optim_ms.train",
                             "weight_norms_per_step.train"},
        "fastpitch-lj.train": set()}
DEVICE = {"fastpitch-lj.serve-doc": {"acoustic_ms.batch", "vocoder_span_ms.batch",
                                     "to_host_ms.batch"},
          "fastpitch-lj.serve-single": set(), "hifigan-v1.train": set(),
          "fastpitch-lj.train": set()}
SPAN_METRICS = set().union(*HOST.values(), *DEVICE.values())


def test_every_span_metric_is_in_the_benchmark():
    import json

    per_layer = {m["name"]: m for m in json.loads((REPO / "BENCHMARK.json").read_text())
                 ["per_layer"]}
    assert SPAN_METRICS <= set(per_layer)
    for name in SPAN_METRICS:
        assert per_layer[name]["source"] in ("program_span", "program_counter"), name
    for cell in cells():
        for name in HOST[cell] | DEVICE[cell]:
            assert per_layer[name]["workloads"] == [cell], name


@pytest.mark.parametrize("cell", cells())
def test_traced_rehearsal_reads_the_programs_spans(cell):
    from neuraltexttospeech_torch.utils import profiling

    profiling.reset()
    result, _ = rehearse(cell, trace=True)
    got = result["metrics"]
    for name in HOST[cell]:
        assert got[name]["value"] > 0, name
    assert not DEVICE[cell] & set(got)  # no card: no device time
    if cell == "hifigan-v1.train":
        assert got["gan_step_ms.train"]["value"] > (got["gan_backward_ms.train"]["value"]
                                                   + got["gan_optim_ms.train"]["value"])
    if cell == "fastpitch-lj.serve-single":
        assert got["casts_per_request.single"]["value"] == int(
            got["casts_per_request.single"]["value"])


@pytest.mark.parametrize("cell", cells())
def test_a_program_without_spans_gives_none(cell, monkeypatch):
    from neuraltexttospeech_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    result, _ = rehearse(cell, trace=True)
    assert not SPAN_METRICS & set(result["metrics"])
