"""The channels-last route of the port's 1-D convs (``nn/layers.py``:
``nhwc_route``, ``nhwc_conv1d``).

- On the CPU: the route's 2-D conv on views (time on H at batch 1, on W
  after), called directly in f32, against ``F.conv1d`` /
  ``F.conv_transpose1d`` at the HiFi-GAN generator's and FastPitch's shapes,
  exactly, and its output's channels-last strides; with the route
  forced on (its layout test alone, the CPU standing in for the card), a
  ``ConvNorm`` returns contiguous ``[B, T, C]``, the generator stays
  channels-last, and each family's serving path gives its values on the
  usual path. The route stays off for f32, the CPU's bf16 (its f32-accumulate
  path bit for bit), grouped convs and inputs contiguous in ``[B, C, T]``;
  inside a tally each bf16 card conv counts ``conv.nhwc`` or ``conv.nchw``,
  and nothing else counts (a tensor that reports itself on a card stands in
  for one).
- On the card (``-m gpu``): the bf16 generator and ``FastPitch.infer`` on the
  route against the usual path, within one bf16 ulp of the output's scale
  (bit-equality printed); a profile of a bf16 generator forward and of a
  ``ConvNorm`` forward and backward holds no cuDNN layout transpose, where
  the usual path holds them; each other family's bf16 serving forward runs
  on the route.

No JAX here, so the file also runs on the card (``--noconftest``).
"""

import math
import pathlib
import sys

import numpy as np
import pytest
import torch
from torch.nn import functional as F

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from neuraltexttospeech_torch.nn import layers  # noqa: E402
from neuraltexttospeech_torch.nn.precision import compute_dtype  # noqa: E402
from neuraltexttospeech_torch.utils import profiling  # noqa: E402

CPU = torch.device("cpu")
BF16 = torch.bfloat16
TRANSPOSES = ("nchwToNhwc", "nhwcToNchw")


def _lies_channels_last(x, groups):
    """``nhwc_route`` without its dtype and device terms: the route forced
    on wherever the layout allows it."""
    return (groups == 1 and x.dim() == 3 and (x.shape[1] == 1 or x.stride(1) == 1)
            and (x.shape[2] == 1 or x.stride(2) == x.shape[1]))


@pytest.fixture
def forced(monkeypatch):
    monkeypatch.setattr(layers, "nhwc_route", _lies_channels_last)


def _btc(b, t, c, seed=0):
    """A contiguous ``[B, T, C]`` viewed ``[B, C, T]``: channels-last."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(b, t, c, generator=g).transpose(1, 2)


def _is_channels_last(y):
    return y.transpose(1, 2).is_contiguous()


def _gap(y, ref):
    """The largest difference over the reference's scale."""
    return float((y.float() - ref.float()).abs().max() / ref.float().abs().max())


# (c_in, c_out, kernel, stride, dilation, transposed): the v1 generator's
# conv_pre, resblock convs (kernels 3/7/11 at dilations 1/3/5), conv_post and
# upsampling transposes; FastPitch's FFT convs, k1 convs and the pitch and
# energy embeddings' one input channel
SHAPES = {
    **{f"gen_res_k{k}_d{d}": (256, 256, k, 1, d, False) for k in (3, 7, 11) for d in (1, 3, 5)},
    "gen_conv_pre": (80, 512, 7, 1, 1, False),
    "gen_conv_post": (32, 1, 7, 1, 1, False),
    "gen_up_k16_s8": (512, 256, 16, 8, 1, True),
    "gen_up_k4_s2": (128, 64, 4, 2, 1, True),
    "fp_ff_in": (384, 1536, 3, 1, 1, False),
    "fp_ff_out": (1536, 384, 3, 1, 1, False),
    "fp_k1": (768, 80, 1, 1, 1, False),
    "fp_pitch_emb": (1, 384, 3, 1, 1, False),
}


def _dyadic(*shape, g, scale=1.0):
    """Whole numbers in [-4, 4] times ``scale``: every product and sum of the
    convs below is exact in f32, so any order of summation gives one value."""
    return torch.randint(-4, 5, shape, generator=g).float() * scale


@pytest.mark.parametrize("batch", [1, 2], ids=["b1_time_on_h", "b2_time_on_w"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_nhwc_conv1d_matches_conv1d(shape, batch):
    c_in, c_out, k, s, d, transposed = SHAPES[shape]
    g = torch.Generator().manual_seed(1)
    x = _dyadic(batch, 48, c_in, g=g).transpose(1, 2)
    b = _dyadic(c_out, g=g, scale=0.25)
    if transposed:
        w = _dyadic(c_in, c_out, k, g=g, scale=1 / 16)
        pad = (k - s) // 2
        ref = F.conv_transpose1d(x, w, b, s, pad)
        y = layers.nhwc_conv1d(x, w, b, s, pad, output_padding=0)
    else:
        w = _dyadic(c_out, c_in, k, g=g, scale=1 / 16)
        pad = layers.same_padding(k, d)
        ref = F.conv1d(x, w, b, s, pad, d)
        y = layers.nhwc_conv1d(x, w, b, s, pad, d)
    assert y.shape == ref.shape and ref.abs().max() > 1
    assert torch.equal(y, ref)
    assert _is_channels_last(y)


# ------------------------------------------------------------ forced on the CPU

def test_conv_norm_returns_contiguous_btc(forced):
    g = torch.Generator().manual_seed(2)
    conv = layers.ConvNorm(384, 1536, 3)
    with torch.no_grad():
        conv.weight.copy_(_dyadic(1536, 384, 3, g=g, scale=1 / 16))
        conv.bias.copy_(_dyadic(1536, g=g, scale=0.25))
        x = _dyadic(2, 40, 384, g=g)
        y = conv(x)
        assert y.shape == (2, 40, 1536) and y.is_contiguous()
        with pytest.MonkeyPatch.context() as m:
            m.setattr(layers, "nhwc_route", lambda x, groups: False)
            want = conv(x)
    assert not want.is_contiguous()  # the usual path returns a transposed view
    assert torch.equal(y, want)


def test_forced_generator_stays_channels_last(forced):
    from neuraltexttospeech_torch.models.hifigan import Generator, HiFiGANConfig

    torch.manual_seed(3)
    gen = Generator(HiFiGANConfig(upsample_initial_channel=64)).eval()
    seen = []
    hooks = [m.register_forward_hook(lambda m, i, o: seen.append(_is_channels_last(o)))
             for m in gen.modules() if isinstance(m, (layers.Conv1d, layers.ConvTranspose1d))]
    mel = torch.randn(2, 24, 80)
    with torch.no_grad():
        y = gen(mel)
        for h in hooks:
            h.remove()
        with pytest.MonkeyPatch.context() as m:
            m.setattr(layers, "nhwc_route", lambda x, groups: False)
            want = gen(mel)
    assert len(seen) == 1 + 4 + 4 * 3 * 6 + 1 and all(seen)
    assert y.shape == (2, 24 * 256, 1) and y.is_contiguous()
    assert _gap(y, want) <= 1e-5


TINY_HG = dict(resblock="2", upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
               upsample_initial_channel=32, resblock_kernel_sizes=(3,),
               resblock_dilation_sizes=((1, 2),), n_fft=64, hop_size=16, win_size=64,
               num_mels=80)
FAMILIES = ["fastpitch", "fastspeech2", "talknet", "gradtts", "flowtron", "tacotron2",
            "diffwave"]


def _family(name, dtype=None):
    """A tiny model of ``name`` (the serving tests' sizes) and the call that
    runs its serving path on ``device``: ``[(mel, audio)]`` as numpy."""
    from neuraltexttospeech_torch.cli import (
        fastpitch_infer, fastspeech2_infer, flowtron_infer, gradtts_infer, tacotron2_infer,
        talknet_infer,
    )
    from neuraltexttospeech_torch.models import (
        diffwave as dw, fastpitch as fp, fastspeech2 as fs2, flowtron as fl, gradtts as gt,
        tacotron2 as t2, talknet as tn,
    )
    from neuraltexttospeech_torch.models.hifigan import Generator, HiFiGANConfig

    torch.manual_seed(0)
    voc = Generator(HiFiGANConfig(**TINY_HG)).eval()
    rng = np.random.default_rng(0)
    enc = [rng.integers(1, 40, n).astype(np.int32) for n in (5, 9, 12, 3)]
    if name == "fastpitch":
        model = fp.FastPitch(fp.FastPitchConfig(
            n_symbols=40, symbols_embedding_dim=32, in_fft_n_layers=1, in_fft_d_head=16,
            in_fft_n_heads=2, in_fft_conv1d_filter_size=64, out_fft_n_layers=1,
            out_fft_d_head=16, out_fft_n_heads=2, out_fft_conv1d_filter_size=64,
            dur_predictor_filter_size=32, pitch_predictor_filter_size=32,
            energy_predictor_filter_size=32)).eval()
        with torch.no_grad():
            model.duration_predictor.fc.bias.fill_(float(np.log(4.0)))
        run = lambda device: fastpitch_infer.synthesize(  # noqa: E731
            model, voc, enc, device=device, batch_size=4, max_mel_len=96, text_bucket=8,
            frame_bucket=1, dtype=dtype)
    elif name == "fastspeech2":
        model = fs2.FastSpeech2(fs2.FastSpeech2Config(
            n_symbols=40, encoder_layer=1, decoder_layer=1, encoder_hidden=32, decoder_hidden=32,
            conv_filter_size=64, variance_filter_size=16, n_bins=16, postnet_dim=24,
            postnet_layers=2)).eval()
        with torch.no_grad():
            model.duration_predictor.fc.bias.fill_(float(np.log(4.0)))
        run = lambda device: fastspeech2_infer.synthesize(  # noqa: E731
            model, voc, enc, device=device, max_mel_len=96, batch_size=4, dtype=dtype)
    elif name == "talknet":
        bb = tn.QuartzNetConfig(module_repeat=1, block_params=((16, 5), (16, 5)),
                                initial_filters=16, initial_kernel=5, penultimate_filters=16,
                                penultimate_kernel=5, final_filters=32)
        cfg = tn.TalkNet2Config(n_symbols=40, emb_dim=32, backbone=bb, dtype=dtype)
        model = tuple(cls(cfg).eval() for cls in (tn.GraphemeDuration, tn.PitchPredictor,
                                                  tn.SpectrogramModel))
        with torch.no_grad():
            model[0].backbone.out.bias.fill_(3.0)
        run = lambda device: talknet_infer.synthesize(  # noqa: E731
            model, voc, enc, device=device, max_mel_len=64, batch_size=4, dtype=dtype)
    elif name == "gradtts":
        model = gt.GradTTS(gt.GradTTSConfig(
            n_symbols=40, n_enc_channels=32, filter_channels=64, filter_channels_dp=32,
            n_enc_layers=1, dec_dim=8)).eval()
        run = lambda device: (out[:3] for out in gradtts_infer.synthesize(  # noqa: E731
            model, voc, enc, device=device, n_timesteps=3, stoc=False, batch_size=4,
            max_mel_len=48, frame_bucket=16, dtype=dtype))
    elif name == "flowtron":
        model = fl.Flowtron(fl.FlowtronConfig(
            n_text=40, n_text_dim=32, n_attn_channels=16, n_hidden=24, n_speaker_dim=8,
            dtype=dtype)).eval()
        run = lambda device: flowtron_infer.synthesize(  # noqa: E731
            model, voc, enc, device=device, batch_size=4, n_frames=24, sigma=0.8, dtype=dtype)
    elif name == "tacotron2":
        model = t2.Tacotron2(t2.Tacotron2Config(
            n_symbols=40, symbols_embedding_dim=32, encoder_embedding_dim=32, decoder_rnn_dim=48,
            attention_rnn_dim=48, attention_dim=16, attention_location_n_filters=4,
            prenet_dim=16, postnet_embedding_dim=24, max_decoder_steps=20, dtype=dtype)).eval()
        run = lambda device: tacotron2_infer.synthesize(  # noqa: E731
            model, voc, enc, device=device, batch_size=4, dtype=dtype)
    else:
        model = dw.DiffWave(dw.DiffWaveConfig(residual_layers=3, residual_channels=16,
                                              dilation_cycle_length=2))
        torch.nn.init.normal_(model.output_projection.weight)  # zero-initialised
        g = torch.Generator().manual_seed(4)
        audio, mel = torch.randn(2, 4 * 256, generator=g), torch.randn(2, 4, 80, generator=g)

        def run(device):
            model.to(device)
            with torch.no_grad(), compute_dtype(dtype):
                out = model(audio.to(device), torch.tensor([3, 7], device=device),
                            mel.to(device))
            return [(0, out.float().cpu().numpy(), out.float().cpu().numpy())]

    return lambda device: [(np.asarray(mel), np.asarray(audio))
                           for _, mel, audio in run(device)]


@pytest.mark.parametrize("family", FAMILIES)
def test_forced_route_serves_every_family_as_the_usual_path(family, monkeypatch):
    run = _family(family)
    want = run(CPU)
    monkeypatch.setattr(layers, "nhwc_route", _lies_channels_last)
    got = run(CPU)
    assert len(got) == len(want)
    for (mel, audio), (wmel, waudio) in zip(got, want):
        assert mel.shape == wmel.shape and audio.shape == waudio.shape
        np.testing.assert_allclose(mel, wmel, atol=1e-5 * max(1.0, np.abs(wmel).max()), rtol=0)
        np.testing.assert_allclose(audio, waudio, atol=1e-5, rtol=0)


# ---------------------------------------------------------- when it stays off

class OnCard(torch.Tensor):
    """A CPU tensor that reports itself on a card: the route's and the
    counters' device test, with the arithmetic left on the CPU."""

    @property
    def is_cuda(self):
        return True


def _input(layout, c=16, t=12):
    if layout == "btc":
        return _btc(2, t, c)
    if layout == "slice":  # a slice in time of a [B, T, C]: the batch stride is free
        return _btc(2, t + 5, c)[:, :, :t]
    if layout == "one_channel":  # contiguous [B, 1, T]: both layouts at once
        return torch.randn(2, 1, t)
    return torch.randn(2, c, t)  # "bct": contiguous [B, C, T]


ROUTE = [  # (input layout, compute dtype, on a card, groups, the route)
    ("btc", BF16, True, 1, True),
    ("slice", BF16, True, 1, True),
    ("one_channel", BF16, True, 1, True),
    ("btc", None, True, 1, False),            # f32
    ("btc", torch.float32, True, 1, False),   # f32, set
    ("btc", BF16, False, 1, False),           # the CPU's bf16
    ("btc", BF16, True, 2, False),            # grouped
    ("bct", BF16, True, 1, False),            # contiguous [B, C, T]
]


@pytest.mark.parametrize("layout,dtype,card,groups,route", ROUTE)
def test_nhwc_route_is_chosen_by_dtype_device_groups_and_strides(layout, dtype, card, groups,
                                                                  route):
    x = _input(layout)
    if card:
        x = x.as_subclass(OnCard)
    with compute_dtype(dtype):
        assert layers.nhwc_route(x, groups) is route


def _cpu_bf16_conv(x, w, b, conv, **kw):
    """The CPU's bf16 conv as ``promoted_conv`` computes it: f32 on the bf16
    values, the output rounded to bf16 once, the bf16 bias added after."""
    y = conv(x.to(BF16).float(), w.to(BF16).float(), None, **kw).to(BF16)
    return y + b.to(BF16)[:, None]


@pytest.mark.parametrize("layout", ["btc", "bct"])
@pytest.mark.parametrize("transposed", [False, True], ids=["conv", "transposed"])
def test_cpu_bf16_keeps_the_f32_accumulate_path_bit_for_bit(layout, transposed):
    torch.manual_seed(5)
    x = _input(layout, c=16, t=20)
    if transposed:
        m = layers.ConvTranspose1d(16, 8, 8, stride=4, padding=2)
        want = _cpu_bf16_conv(x, m.weight, m.bias, F.conv_transpose1d, stride=4, padding=2)
    else:
        m = layers.Conv1d(16, 8, 7, padding=9, dilation=3)
        want = _cpu_bf16_conv(x, m.weight, m.bias, F.conv1d, padding=9, dilation=3)
    with torch.no_grad(), compute_dtype(BF16), profiling.tally() as counts:
        y = m(x)
    assert y.dtype == BF16 and torch.equal(y, want)
    assert not {k for k in counts if k.startswith("conv.")}


COUNTS = [  # (module, input layout, compute dtype, the layout counts)
    ("conv", "btc", BF16, {"conv.nhwc": 1}),
    ("conv", "one_channel", BF16, {"conv.nhwc": 1}),
    ("transposed", "btc", BF16, {"conv.nhwc": 1}),
    ("conv", "bct", BF16, {"conv.nchw": 1}),
    ("transposed", "bct", BF16, {"conv.nchw": 1}),
    ("grouped", "btc", BF16, {"conv.nchw": 1}),
    ("conv2d", "btc", BF16, {"conv.nchw": 1}),
    ("conv", "btc", None, {}),
    ("transposed", "btc", None, {}),
    ("grouped", "bct", None, {}),
]


@pytest.mark.parametrize("module,layout,dtype,want", COUNTS)
def test_each_bf16_card_conv_counts_its_layout(module, layout, dtype, want):
    torch.manual_seed(6)
    x = _input(layout, c=16, t=12)
    if module == "conv":
        m = layers.Conv1d(x.shape[1], 8, 3, padding=1)
    elif module == "transposed":
        m = layers.ConvTranspose1d(x.shape[1], 8, 4, stride=2, padding=1)
    elif module == "grouped":
        m = layers.Conv1d(16, 8, 3, padding=1, groups=2)
    else:
        m = layers.Conv2d(2, 4, (3, 3), padding=1)
        x = x.reshape(2, 2, 8, 12)
    with torch.no_grad(), compute_dtype(dtype), profiling.tally() as counts:
        y = m(x.as_subclass(OnCard))
    assert {k: v for k, v in counts.items() if k.startswith("conv.")} == want
    assert torch.isfinite(y.float()).all()


# ------------------------------------------------------------------ on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _usual(monkeypatch, run):
    """``run()`` with the route off: every conv on PyTorch's 1-D path."""
    with monkeypatch.context() as m:
        m.setattr(layers, "nhwc_route", lambda x, groups: False)
        return run()


def _ulp(scale):
    """One bf16 ulp at ``scale``: 2^(floor(log2 scale) − 7)."""
    return 2.0 ** (math.floor(math.log2(scale)) - 7)


def _within_an_ulp(name, y, want):
    y, want = y.float(), want.float()
    diff, scale = float((y - want).abs().max()), float(want.abs().max())
    print(f"{name}: max |route - usual| {diff:.3e}, output scale {scale:.3e}, "
          f"bf16 ulp there {_ulp(scale):.3e}, bit-equal {torch.equal(y, want)}")
    assert diff <= _ulp(scale)


@pytest.mark.gpu
def test_cuda_bf16_generator_on_the_route_matches_the_usual_path(card, monkeypatch):
    from neuraltexttospeech_torch.models.hifigan import Generator, HiFiGANConfig

    torch.manual_seed(7)
    gen = Generator(HiFiGANConfig.v1()).to(card).eval()
    mel = torch.randn(2, 128, 80, device=card)
    with torch.no_grad(), compute_dtype(BF16):  # no inference mode: no CUDA graph
        with profiling.tally() as counts:
            y = gen(mel)
        want = _usual(monkeypatch, lambda: gen(mel))
    assert counts.get("conv.nhwc") == 1 + 4 + 4 * 3 * 6 + 1 and "conv.nchw" not in counts
    _within_an_ulp("generator v1, 2 x 128 frames", y, want)


@pytest.mark.gpu
def test_cuda_bf16_fastpitch_infer_on_the_route_matches_the_usual_path(card, monkeypatch):
    from neuraltexttospeech_torch.models.fastpitch import FastPitch, FastPitchConfig

    torch.manual_seed(8)
    fp = FastPitch(FastPitchConfig()).to(card).eval()
    with torch.no_grad():
        fp.duration_predictor.fc.bias.fill_(float(np.log(4.0)))
    text = torch.randint(1, 148, (2, 64), device=card)
    with torch.no_grad(), compute_dtype(BF16):
        with profiling.tally() as counts:
            mel, lens, dur, pitch = fp.infer(text, max_mel_len=1024)
        wmel, wlens, wdur, wpitch = _usual(monkeypatch, lambda: fp.infer(text, max_mel_len=1024))
    assert counts.get("conv.nhwc", 0) > 0 and "conv.nchw" not in counts
    _within_an_ulp("FastPitch.infer durations", dur, wdur)
    _within_an_ulp("FastPitch.infer pitch", pitch, wpitch)
    if torch.equal(lens, wlens):
        _within_an_ulp("FastPitch.infer mel", mel, wmel)


def _kernels(run):
    """The names of the CUDA kernels ``run()`` launches, with repeats."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def _transposes(names):
    return [n for n in names if any(t in n for t in TRANSPOSES)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["generator_b2_f128", "generator_b1_f640", "conv_norm"])
def test_cuda_profile_holds_no_layout_transposes(card, monkeypatch, case):
    """No cuDNN layout transpose but the one of ``conv_post``, whose single
    output channel cuDNN pads to 8 and drops again with ``nhwcToNchw``; and
    at batch 1, 640 frames, no direct conv kernel (cuDNN's pick with time
    on W, 10-15 ms a conv)."""
    if case.startswith("generator"):
        from neuraltexttospeech_torch.models.hifigan import Generator, HiFiGANConfig

        batch, frames = (1, 640) if case == "generator_b1_f640" else (2, 128)
        torch.manual_seed(9)
        gen = Generator(HiFiGANConfig.v1()).to(card).eval()
        mel = torch.randn(batch, frames, 80, device=card)
        padded_outputs = 1

        def run():
            with torch.no_grad(), compute_dtype(BF16):
                gen(mel)
    else:
        torch.manual_seed(10)
        conv = layers.ConvNorm(384, 1536, 3).to(card)
        x = torch.randn(4, 200, 384, device=card, requires_grad=True)
        padded_outputs = 0

        def run():
            with compute_dtype(BF16):
                conv(x).float().square().sum().backward()
    run()  # cuDNN's plans, outside the profile
    _usual(monkeypatch, run)
    names = _kernels(run)
    assert len(_transposes(names)) == padded_outputs, _transposes(names)
    assert not [n for n in names if "conv2d_grouped_direct" in n]
    assert len(_transposes(_usual(monkeypatch, lambda: _kernels(run)))) > 2  # the usual path's


@pytest.mark.gpu
@pytest.mark.parametrize("family", [f for f in FAMILIES if f != "fastpitch"])
def test_cuda_bf16_family_forward_runs_on_the_route(card, family):
    run = _family(family, BF16)
    with compute_dtype(BF16), profiling.tally() as counts:
        out = run(card)
    print(f"{family}: {counts.get('conv.nhwc', 0)} convs on the route, "
          f"{counts.get('conv.nchw', 0)} on the usual path")
    assert out and all(np.isfinite(mel).all() and np.isfinite(audio).all() for mel, audio in out)
    assert counts.get("conv.nhwc", 0) > 0
