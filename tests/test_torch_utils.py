"""The port's profiling, plotting and ``AttrDict`` utilities
(``neuraltexttospeech_torch/utils``) and the host-fed throughput tool
(``tools/torch_cli_throughput.py``), on the CPU.

The utilities are held as ``tests/test_misc.py:57-86`` holds JAX's, and
against JAX's on the same inputs: the plots give the same pixels, and
``AttrDict.override`` the same dict. ``trace`` writes a Chrome trace of a
CPU op inside a span (the spans themselves: ``tests/test_torch_tracing.py``). The tool's ``build_corpus`` and its parsers of the trainer CLIs' epoch
lines run here; the CLIs themselves run on the card (``chip_smoke.py``).
"""

import json
import wave

import numpy as np
import pytest
import torch

from neuraltexttospeech_torch.utils import masking, plotting, profiling
from neuraltexttospeech_tpu.utils import masking as jax_masking
from neuraltexttospeech_tpu.utils import plotting as jax_plotting
from tools import torch_cli_throughput as tool


def test_plotting_roundtrip_matches_jax():
    spec = np.random.default_rng(0).standard_normal((40, 80)).astype(np.float32)
    img = plotting.save_figure_to_numpy(plotting.plot_spectrogram(torch.as_tensor(spec), "s"))
    assert img.ndim == 3 and img.shape[-1] == 3 and img.dtype == np.uint8
    want = jax_plotting.save_figure_to_numpy(jax_plotting.plot_spectrogram(spec, "s"))
    np.testing.assert_array_equal(img, want)
    fig = plotting.plot_alignment(np.eye(20))
    np.testing.assert_array_equal(plotting.save_figure_to_numpy(fig),
                                  jax_plotting.save_figure_to_numpy(
                                      jax_plotting.plot_alignment(np.eye(20))))


def test_attrdict_override_matches_jax():
    got, want = masking.AttrDict(x=1), jax_masking.AttrDict(x=1)
    for a in (got, want):
        a.override({"y": 2}).override([{"z": 3}, None, ({"x": 4},)])
    assert (got.x, got.y, got.z) == (4, 2, 3) and got["y"] == 2
    assert dict(got) == dict(want)
    with pytest.raises(NotImplementedError):
        got.override(5)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")):
        with profiling.span("matmul_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = (tmp_path / "t").glob("trace_*.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "matmul_region" in names and "aten::mm" in names


def test_cli_throughput_corpus(tmp_path):
    items, train = tool.build_corpus(tmp_path, 3, 4)
    rows = items.read_text().splitlines()
    assert len(rows) == 3 and train.read_text().splitlines() == rows * 4
    for i, row in enumerate(rows):
        path, text = row.split("|")
        with wave.open(path) as w:
            assert w.getframerate() == tool.SR
            assert w.getnframes() == tool.MEL_LENS[i % len(tool.MEL_LENS)] * tool.HOP
        assert len(text.split()) == 18


def test_cli_throughput_parses_the_epoch_lines():
    # fastpitch_train's epoch line (fit_epoch's means) and its validation line
    assert tool.fastpitch_rate("epoch 1: attn_loss=0.5051 loss=6.1747 "
                               "steps_per_sec=5.2919") == 5.2919
    assert tool.fastpitch_rate("epoch 1 val: loss=6.1 steps_per_sec=2.0") is None
    assert tool.fastpitch_rate("epoch 1 step 50 loss=6.1 steps/s=2.00") is None
    # hifigan_train's epoch line
    assert tool.hifigan_rate("epoch 0: 8 steps in 2.5s (65.3x realtime audio "
                             "throughput)") == pytest.approx(3.2)
    assert tool.hifigan_rate("epoch 0 step 100 gen_loss=1.0") is None
    lines = tool.summary("fastpitch (f32)", [1.0, 4.0, 5.0], device_ms=100.0)
    assert lines[0].endswith("[1.0, 4.0, 5.0]")
    assert "5.000 steps/s = 200.0 ms/step" in lines[1]
    assert "CLI efficiency 50.0%" in lines[2]
