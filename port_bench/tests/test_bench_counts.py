"""The analytic FLOP counts of ``counts/`` equal what
``torch.utils.flop_counter.FlopCounterMode`` counts on the plain references
at a small width."""

import json
import pathlib

import torch
from torch.utils import flop_counter
from torch.utils.flop_counter import FlopCounterMode

from port_bench.reference import load_by_path
from port_bench.reference.nets import Arith, FastPitchRef, GeneratorRef, MPDRef, MSDRef, gan_losses
from port_bench.yardstick import weights

from ._tiny import overrides

BENCH = pathlib.Path(__file__).resolve().parents[1]
TINY = overrides("fastpitch-lj.serve-doc")[0]
FASTPITCH, GENERATOR = TINY["fastpitch"], TINY["vocoder"]


def _counts(name):
    return load_by_path(BENCH / "counts" / f"{name}.py", "port_bench.counts")


def _config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def _seeded(module, rule="random_init"):
    weights.load(module, weights.make(weights.spec(module), 5, torch.device("cpu"), rule))
    return module


def test_serving_flops_match_the_flop_counter():
    cfg = _config("fastpitch-lj")
    cfg["fastpitch"].update(FASTPITCH)
    cfg["vocoder"].update(GENERATOR)
    fp = _seeded(FastPitchRef(cfg["fastpitch"]))
    gen = _seeded(GeneratorRef(cfg["vocoder"]))
    a = Arith("f32")
    ids = torch.randint(1, 60, (23,))
    with torch.no_grad():
        enc, dur = fp.durations(a, ids)
    reps = torch.full((23,), 3, dtype=torch.long)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        fp.durations(a, ids)
        mel = fp.decode(a, enc, reps, 69)
        gen(a, mel[None])
    # the decoder runs over max_len = 69 = 23 · 3 frames, no padding
    assert fc.get_total_flops() == _counts("fastpitch-lj").utterance_flops(cfg, 23, 69)


def _grouped_conv_backward(grad_out_shape, x_shape, w_shape, bias, stride, padding, dilation,
                           transposed, output_padding, groups, output_mask, out_shape):
    """``FlopCounterMode``'s count of a conv's backward, with a grouped
    conv's weight gradient counted as the grouped product it is (the stock
    formula counts it as if every input channel met every output channel,
    ``groups`` times too much)."""
    args = (grad_out_shape, x_shape, w_shape, bias, stride, padding, dilation, transposed,
            output_padding, groups)
    total = flop_counter.conv_backward_flop.__wrapped__(*args, output_mask, out_shape)
    if output_mask[1] and groups > 1:
        weight = flop_counter.conv_backward_flop.__wrapped__(*args, [False, True, False], out_shape)
        total -= weight - weight // groups
    return total


def test_gan_step_flops_match_the_flop_counter():
    cfg = _config("hifigan-v1")
    h = {**cfg["hifigan"], **GENERATOR}
    cfg["hifigan"] = h
    a = Arith("f32")
    gen = _seeded(GeneratorRef(h, weight_norm=True), "flax_init")
    mpd, msd = _seeded(MPDRef(), "flax_init"), MSDRef()
    weights.load(msd, weights.make(weights.spec(msd, [n for n, _ in msd.named_buffers()
                                                      if n.endswith(".u")]),
                                   5, torch.device("cpu"), "flax_init"))
    y = torch.randn(2, 1024) * 0.1
    mapping = {torch.ops.aten.convolution_backward: _grouped_conv_backward}
    with FlopCounterMode(display=False, custom_mapping=mapping) as fc:
        g, d = gan_losses(a, gen, mpd, msd, y, h)
        (g + d).backward()
    assert fc.get_total_flops() == _counts("hifigan-v1").step_flops(cfg, 2, 1024)


def test_train_flops_match_the_flop_counter():
    """A FastPitch training micro-step of the reference (forward, losses and
    backward) at a small width and padded shapes."""
    cfg = _config("fastpitch-lj")
    cfg["fastpitch"].update(FASTPITCH)
    mix = json.loads((BENCH / "traffic" / "fastpitch-train.json").read_text())
    ref = load_by_path(BENCH / "reference" / "fastpitch-lj.train.py", "port_bench.reference")
    net = _seeded(FastPitchRef(cfg["fastpitch"]))
    gen = torch.Generator().manual_seed(1)
    in_lens, mel_lens = torch.tensor([9, 6]), torch.tensor([40, 27])
    text = torch.randint(1, 60, (2, 16), generator=gen) * (torch.arange(16) < in_lens[:, None])
    frames = (torch.arange(48) < mel_lens[:, None]).float()
    mel = torch.randn(2, 48, 80, generator=gen) * frames[..., None]
    batch = {"text": text, "input_lens": in_lens, "mel": mel, "mel_lens": mel_lens,
             "pitch": torch.randn(2, 1, 48, generator=gen) * frames[:, None],
             "energy": mel.norm(dim=2)}
    with FlopCounterMode(display=False) as fc:
        terms, *_ = ref.micro_step(net, Arith("f32"), batch, mix["loss"], lambda x, p: x, ref.mas)
        terms["loss"].backward()
    assert fc.get_total_flops() == _counts("fastpitch-lj").train_flops(cfg, 2, 16, 48)
