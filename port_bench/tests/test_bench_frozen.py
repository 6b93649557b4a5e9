"""The yardstick's frozen copies equal their origins as they stood when they
were copied (the origins' values recorded in ``origin_golden.json``), so
they keep serving when the program's originals change."""

import hashlib
import json
import pathlib

import numpy as np
import pytest
import torch

from port_bench.yardstick import bounds, breakdown, synth, weights

HERE = pathlib.Path(__file__).parent
BENCH = HERE.parent
GOLDEN = json.loads((HERE / "origin_golden.json").read_text())
TRANSCRIPTS_SHA256 = "70cb681247803c423b34bc4bea5bfc4ce6d0a94327a55a1816942e18cb14d093"


@pytest.mark.parametrize("name", sorted(GOLDEN["origin_sha256"]))
def test_text_front_end_copies_are_the_origin(name):
    got = hashlib.sha256((BENCH / "reference" / name).read_bytes()).hexdigest()
    assert got == GOLDEN["origin_sha256"][name]


def test_transcripts_are_the_filelists_text_column():
    assert hashlib.sha256((BENCH / "data" / "ljs_transcripts.txt").read_bytes()).hexdigest() \
        == TRANSCRIPTS_SHA256
    lines = (BENCH / "data" / "ljs_transcripts.txt").read_text(encoding="utf-8").splitlines()
    assert len(lines) == 12496 and min(map(len, lines)) == 12 and max(map(len, lines)) == 187


def test_logmel_bound_is_the_origins():
    got = [list(bounds.logmel_bound_ms(n, bounds.MelConfig(mel_fmax=fm))[::2])
           for n in (512, 861, 6864) for fm in (8000.0, 11025.0)]
    np.testing.assert_allclose(got, GOLDEN["values"]["logmel"], rtol=1e-12)


def test_msd_shapes_and_tap_dots_bounds_are_the_origins():
    shapes = bounds.msd_tap_shapes(16, 8192)
    assert [[s[0], s[1], list(s[2]), list(s[3])] for s in shapes] \
        == GOLDEN["values"]["msd_tap_shapes"]
    got = [[bounds.tap_dots_bound_ms(s[2], d)[0] for d in ("f32", "bf16")] for s in shapes]
    np.testing.assert_allclose(got, GOLDEN["values"]["tap_dots"], rtol=1e-12)


def test_mas_bound_is_the_origins():
    got = [bounds.mas_bound_ms(16, 768, 128, [768 - 24 * i for i in range(16)])[0],
           bounds.mas_bound_ms(16, 870, 192, [870] * 16)[0]]
    np.testing.assert_allclose(got, GOLDEN["values"]["mas"], rtol=1e-12)


def test_synthetic_wavs_are_the_origins():
    w = synth.synthetic_wavs(3, 0.01, 7)
    assert hashlib.sha256(w.tobytes()).hexdigest() == GOLDEN["values"]["synthetic_wavs_sha"]


def test_device_wavs_follow_the_recipe():
    w = synth.synthetic_wavs_device(64, 4096, 2 ** 40 + 3, torch.device("cpu"))
    assert w.dtype == torch.float32 and w.shape == (64, 4096)
    assert float(w.abs().max()) < 0.85
    assert torch.equal(w, synth.synthetic_wavs_device(64, 4096, 2 ** 40 + 3, torch.device("cpu")))


def test_kernel_categories_are_the_origins():
    for name, cat in GOLDEN["values"]["category"].items():
        assert breakdown.category(name) == cat, name


def test_union_counts_overlaps_once():
    assert breakdown.union([(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)]) == 4.0


@pytest.mark.parametrize("rule", ["random_init", "flax_init"])
def test_weight_rules_are_the_origins(rule):
    """Zeros, ones and per-leaf scales as ``random_init_`` and
    ``init_params_`` set them, for every leaf of a small generator."""
    from neuraltexttospeech_torch.models.hifigan import Generator, HiFiGANConfig

    g = Generator(HiFiGANConfig(upsample_initial_channel=16), weight_norm=(rule == "flax_init"))
    w = weights.make(weights.spec(g), 3, torch.device("cpu"), rule)
    for name, p in g.named_parameters():
        v = w[name]
        if name.endswith("bias"):
            assert not v.any(), name
        elif name.endswith("original1") or (rule == "random_init" and p.ndim == 1):
            assert torch.all(v == 1), name
        elif p.numel() >= 1000:  # a scale read from enough draws
            fan_in = p[0].numel()
            assert abs(float(v.std()) * fan_in ** 0.5 - 1) < 0.1, name
    assert torch.equal(w[name], weights.make(weights.spec(g), 3, torch.device("cpu"), rule)[name])
