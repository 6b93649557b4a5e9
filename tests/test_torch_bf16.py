"""The port's bf16 mode (``nn/precision.py``, ``--amp``) against the JAX
package's ``dtype=jnp.bfloat16`` paths, on the CPU, same weights and inputs.

bf16 rounds at other places in the two frameworks, so each compared tensor
is held to JAX's own bf16 error (the yardstick):

    e_port = max |port_bf16 - jax_bf16|,  e_jax = max |jax_bf16 - jax_f32|,
    e_port <= 2 e_jax + 1e-3 max |jax_f32|

and ``pytest -s`` prints both. Covered:

- kernel B2's bf16 twin against the Pallas kernel in interpret mode, forward
  and the backward's dx form, within one bf16 ulp (both sum in f32 and round
  once), and the port's dx against JAX's ``_gouter_tap_dots_bwd``;
- the port's convs in bf16 on the CPU, at shapes where PyTorch's own CPU
  bf16 conv is wrong: an f32 sum rounded once;
- the generator on the ``hifigan`` golden's weights;
- ``FastPitch.infer``: durations and pitch, then the mels with JAX's integer
  durations given to both (a bf16 duration can cross a .5 boundary and shift
  every later frame, which is no fault);
- the ``text2wav`` serving composition on its golden's weights;
- one FastPitch ``Trainer`` step at the golden's small FastPitch, dropout
  off: metrics by the yardstick, and the gradients (``grads_yardstick``:
  the whole gradient, and the median over parameters); each updated
  parameter within ``2.5 lr + 1e-6`` of JAX's (Adam's first update is about
  ``lr sign(g)``, so a gradient whose sign bf16 flips moves a parameter by up
  to 2 lr; that bound holds any gradient, hence the gradients' check). The
  gradients are read from Adam's first moment after the step, ``(1 - b1)
  g`` in both frameworks.

The GAN step is in ``test_torch_bf16_gan.py``.
"""

import dataclasses
import importlib
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from neuraltexttospeech_torch.convert import (  # noqa: E402
    fastpitch_from_flax, fastpitch_train_from_flax, generator_from_flax, hifigan_train_from_flax,
)
from neuraltexttospeech_torch.models import fastpitch as port_fp  # noqa: E402
from neuraltexttospeech_torch.models import hifigan as port_hg  # noqa: E402
from neuraltexttospeech_torch.nn.precision import compute_dtype  # noqa: E402
from neuraltexttospeech_tpu.models import fastpitch as jax_fp  # noqa: E402
from neuraltexttospeech_tpu.models import hifigan as jax_hg  # noqa: E402
from test_torch_kernels import excess_over_one_bf16_ulp  # noqa: E402
from tools.make_goldens import FAMILIES, GOLDEN_DIR  # noqa: E402

BF16 = torch.bfloat16
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def yardstick(what, port, jax_bf16, jax_f32):
    """Hold ``port`` to the bf16 yardstick; print e_port and e_jax."""
    port, jb, jf = (np.asarray(np.asarray(a, np.float32), np.float64)
                    for a in (port, jax_bf16, jax_f32))
    assert port.shape == jb.shape == jf.shape, (what, port.shape, jb.shape, jf.shape)
    e_port, e_jax = np.abs(port - jb).max(), np.abs(jb - jf).max()
    bound = 2 * e_jax + 1e-3 * np.abs(jf).max()
    print(f"bf16 {what}: e_port {e_port:.3e}, e_jax {e_jax:.3e} (bound {bound:.3e})")
    assert e_port <= bound, f"{what}: e_port {e_port:.3e} > {bound:.3e} (e_jax {e_jax:.3e})"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------------ kernel B2

@pytest.mark.parametrize("shape", [(4, 2, 32, 128, 128, 3, 1), (2, 2, 16, 256, 128, 4, 2)])
def test_b2_bf16_twin_matches_pallas_kernel(shape):
    from jax.experimental.pallas import tpu as pltpu

    from neuraltexttospeech_torch.nn import fastconv as port_fc
    from neuraltexttospeech_torch.ops import gouter_kernel
    from neuraltexttospeech_tpu.nn import fastconv as jax_fc
    from neuraltexttospeech_tpu.ops.gouter_kernel import gouter_tap_dots_pallas

    g, B, q, X, Y, kf, s = shape
    qp = q + (kf - 1) * s
    rng = np.random.default_rng(1)
    xp = jnp.asarray(rng.standard_normal((g, B, qp, X)), jnp.bfloat16)
    wf = jnp.asarray(rng.standard_normal((kf, g, X, Y)) / np.sqrt(kf * X), jnp.bfloat16)
    dy = jnp.asarray(rng.standard_normal((g, B, q, Y)), jnp.bfloat16)
    to_t = lambda a: torch.as_tensor(np.array(a.astype(jnp.float32))).to(BF16)  # noqa: E731

    # forward: the Pallas body sums in f32 and rounds once, as the twin does
    with pltpu.force_tpu_interpret_mode():
        want = gouter_tap_dots_pallas(xp, wf, s=s, q=q)
    assert want.dtype == jnp.bfloat16
    got = gouter_kernel.gouter_tap_dots_kernel(to_t(xp), to_t(wf), s, q)
    assert got.dtype == BF16
    excess = excess_over_one_bf16_ulp(got, torch.as_tensor(np.array(want,
                                                                                  np.float32)))
    print(f"bf16 B2 forward {shape}: max excess over one ulp {excess:.3e}")
    assert excess <= 0

    # dx in the flip_t form, as JAX's backward lays it out (dy padded, the
    # weights flipped and transposed), through the Pallas kernel
    pad, q_pad = (kf - 1) * s, (-qp) % 8
    dyp = jnp.pad(dy, ((0, 0), (0, 0), (pad, pad + q_pad), (0, 0)))
    w_rev = jnp.flip(wf, axis=0).transpose(0, 1, 3, 2)
    with pltpu.force_tpu_interpret_mode():
        want_dx = gouter_tap_dots_pallas(dyp, w_rev, s=s, q=qp + q_pad)[:, :, :qp]
    x_t, w_t = to_t(xp).requires_grad_(), to_t(wf).requires_grad_()
    port_fc.gouter_tap_dots(x_t, w_t, s, q).backward(to_t(dy))
    assert x_t.grad.dtype == w_t.grad.dtype == BF16
    excess = excess_over_one_bf16_ulp(
        x_t.grad, torch.as_tensor(np.array(want_dx, np.float32)))
    print(f"bf16 B2 dx {shape}: max excess over one ulp {excess:.3e}")
    assert excess <= 0

    # JAX's own backward off the TPU (bf16 XLA dots, summed in bf16), by the
    # yardstick against its f32 run
    ref = {dt: jax_fc._gouter_tap_dots_bwd(s, q, (xp.astype(dt), wf.astype(dt)), dy.astype(dt))
           for dt in (jnp.bfloat16, jnp.float32)}
    yardstick(f"B2 dx vs _gouter_tap_dots_bwd {shape}", x_t.grad.float().numpy(),
              ref[jnp.bfloat16][0], ref[jnp.float32][0])
    yardstick(f"B2 dw vs _gouter_tap_dots_bwd {shape}", w_t.grad.float().numpy(),
              ref[jnp.bfloat16][1], ref[jnp.float32][1])


@pytest.mark.parametrize("transpose", [False, True])
def test_cpu_bf16_conv_is_an_f32_sum_rounded_once(transpose):
    """Where PyTorch's CPU bf16 conv is wrong (kernel 8 with 8 input
    channels, forward or a transposed conv's input gradient), the port's
    layers give the f32 conv of the bf16 values rounded to bf16 once, in the
    output (to which the bias is then added in bf16, as PyTorch adds it
    after a cuDNN convolution and flax's ``Conv`` after its own) and in the
    input gradient, within one bf16 ulp."""
    from neuraltexttospeech_torch.nn.layers import Conv1d, ConvTranspose1d

    F = torch.nn.functional
    torch.manual_seed(0)
    if transpose:
        layer, conv = ConvTranspose1d(16, 8, 8, stride=4, padding=2), F.conv_transpose1d
    else:
        layer, conv = Conv1d(8, 16, 8, stride=4, padding=2), F.conv1d
    x = torch.randn(2, layer.in_channels, 64).to(BF16).requires_grad_()
    with compute_dtype(BF16):
        y = layer(x)
    dy = torch.randn(y.shape).to(BF16)
    y.backward(dy)
    x32 = x.detach().float().requires_grad_()
    want = conv(x32, layer.weight.detach().to(BF16).float(), None, stride=4, padding=2)
    want.backward(dy.float())
    assert y.dtype == x.grad.dtype == BF16
    assert excess_over_one_bf16_ulp(y, want.to(BF16) + layer.bias.detach().to(BF16)[:, None]) <= 0
    assert excess_over_one_bf16_ulp(x.grad, x32.grad.to(BF16)) <= 0


# --------------------------------------------------------------------- serving

GOLDEN_HG = dict(resblock="2", upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                 upsample_initial_channel=32, resblock_kernel_sizes=(3,),
                 resblock_dilation_sizes=((1, 2),), n_fft=64, hop_size=16,
                 win_size=64, num_mels=8)


def _restored(family):
    from flax import serialization

    variables, _ = FAMILIES[family](train=False)
    return _np(serialization.from_bytes(variables,
                                        (GOLDEN_DIR / f"{family}.msgpack").read_bytes()))


def test_generator_bf16_matches_jax_on_golden_weights():
    params = _restored("hifigan")
    mel = np.random.default_rng(101).standard_normal((2, 10, 8)).astype(np.float32)
    ref = {dt: np.asarray(jax_hg.Generator(jax_hg.HiFiGANConfig(**GOLDEN_HG, dtype=dt))
                          .apply(params, jnp.asarray(mel)), np.float32)
           for dt in (jnp.bfloat16, None)}
    gen = port_hg.Generator(port_hg.HiFiGANConfig(**GOLDEN_HG)).eval()
    gen.load_state_dict(generator_from_flax(params))
    with torch.no_grad(), compute_dtype(BF16):
        audio = gen(torch.as_tensor(mel))
    assert audio.dtype == BF16 and all(p.dtype == torch.float32 for p in gen.parameters())
    yardstick("generator (hifigan golden)", audio.float().numpy(), ref[jnp.bfloat16], ref[None])


def _fp_kw():
    return dict(n_symbols=40, symbols_embedding_dim=64, in_fft_n_layers=2, out_fft_n_layers=2,
                in_fft_n_heads=2, out_fft_n_heads=2, in_fft_d_head=16, out_fft_d_head=16,
                in_fft_conv1d_filter_size=128, out_fft_conv1d_filter_size=128,
                dur_predictor_filter_size=64, pitch_predictor_filter_size=64,
                energy_predictor_filter_size=64)


def test_fastpitch_infer_bf16_matches_jax():
    rng = np.random.default_rng(5)
    lens = np.array([24, 17, 9], np.int32)
    text = rng.integers(1, 40, (3, 24)).astype(np.int32)
    text[np.arange(24)[None, :] >= lens[:, None]] = 0
    models = {dt: jax_fp.FastPitch(jax_fp.FastPitchConfig(**_fp_kw(), dtype=dt))
              for dt in (jnp.bfloat16, None)}
    params = _np(models[None].init(jax.random.PRNGKey(2), jnp.asarray(text), jnp.asarray(lens),
                                   max_mel_len=160, method=jax_fp.FastPitch.infer))
    params["params"]["duration_predictor"]["Dense_0"]["bias"] = np.full((1,), np.log(4.0),
                                                                        np.float32)
    port = port_fp.FastPitch(port_fp.FastPitchConfig(**_fp_kw())).eval()
    port.load_state_dict(fastpitch_from_flax(params))

    def run_jax(dt, **kw):
        out = models[dt].apply(params, jnp.asarray(text), jnp.asarray(lens), max_mel_len=160,
                               method=jax_fp.FastPitch.infer, **kw)
        return [np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)
                for a in out]

    def run_port(**kw):
        with torch.no_grad(), compute_dtype(BF16):
            out = port.infer(torch.as_tensor(text), torch.as_tensor(lens), max_mel_len=160, **kw)
        return [a.float().numpy() if a.is_floating_point() else a.numpy() for a in out]

    jb, jf, ours = run_jax(jnp.bfloat16), run_jax(None), run_port()
    assert port.infer.__self__ is port and ours[0].shape == jb[0].shape
    yardstick("FastPitch infer durations", ours[2], jb[2], jf[2])
    yardstick("FastPitch infer pitch", ours[3], jb[3], jf[3])

    # the mels, with JAX's integer durations given to both
    dur = np.floor(jb[2] + 0.5).astype(np.float32)
    jb, jf = run_jax(jnp.bfloat16, dur_tgt=jnp.asarray(dur)), run_jax(None, dur_tgt=jnp.asarray(dur))
    ours = run_port(dur_tgt=torch.as_tensor(dur))
    np.testing.assert_array_equal(ours[1], jb[1])
    assert jb[1].min() > 0
    yardstick("FastPitch infer mel (JAX durations)", ours[0], jb[0], jf[0])


def test_text2wav_bf16_matches_jax_composition():
    """The serving loop in bf16 on the text2wav golden's weights against the
    golden's own wiring (``tools/make_goldens.py:434-450``) in JAX bf16:
    durations by the yardstick, then mel and audio with JAX's bf16 integer
    durations given to both models (JAX bf16 rounds this phrase to 11
    frames where f32 gives 10: a .5 boundary)."""
    import functools

    from neuraltexttospeech_torch.cli import fastpitch_infer
    from neuraltexttospeech_torch.text.processing import TextProcessing
    from neuraltexttospeech_tpu.utils.serving import round_up

    restored = _restored("text2wav")
    fp_kw = dict(symbols_embedding_dim=64, in_fft_n_layers=1, in_fft_d_head=16,
                 in_fft_n_heads=2, in_fft_conv1d_filter_size=128, out_fft_n_layers=1,
                 out_fft_d_head=16, out_fft_n_heads=2, out_fft_conv1d_filter_size=128,
                 dur_predictor_filter_size=32, pitch_predictor_filter_size=32,
                 energy_predictor_filter_size=32)
    hg_kw = dict(GOLDEN_HG, num_mels=80)
    tp = TextProcessing("english_basic", ["english_cleaners_v2"], p_arpabet=0.0)
    encoded = np.asarray(tp.encode_text("The quick brown fox."), np.int32)
    text = jnp.asarray(encoded)[None]

    def run_jax(dt, **kw):
        mel, dec_lens, dur = jax_fp.FastPitch(jax_fp.FastPitchConfig(**fp_kw, dtype=dt)).apply(
            restored["fastpitch"], text, jnp.asarray([text.shape[1]], jnp.int32),
            max_mel_len=128, method=jax_fp.FastPitch.infer, **kw)[:3]
        mel = mel.astype(jnp.float32)
        n = int(np.asarray(dec_lens)[0])
        audio = jax_hg.Generator(jax_hg.HiFiGANConfig(**hg_kw, dtype=dt)).apply(
            restored["hifigan"], mel[:, :min(round_up(n, 32), 128)])
        return (n, np.asarray(mel)[0, :n], np.asarray(audio.astype(jnp.float32))[0, :n * 16, 0],
                np.asarray(dur.astype(jnp.float32))[0])

    fp = port_fp.FastPitch(port_fp.FastPitchConfig(**fp_kw)).eval()
    fp.load_state_dict(fastpitch_from_flax(restored["fastpitch"]))
    gen = port_hg.Generator(port_hg.HiFiGANConfig(**hg_kw)).eval()
    gen.load_state_dict(generator_from_flax(restored["hifigan"]))
    with torch.no_grad(), compute_dtype(BF16):
        dur = fp.infer(torch.as_tensor(encoded)[None], None, max_mel_len=128)[2]
    dur_b, dur_f = run_jax(jnp.bfloat16)[3], run_jax(None)[3]
    yardstick("text2wav durations", dur.float().numpy()[0], dur_b, dur_f)

    dur_tgt = np.floor(dur_b + 0.5)[None]
    fp.infer = functools.partial(fp.infer, dur_tgt=torch.as_tensor(dur_tgt))
    (_, mel, audio), = fastpitch_infer.synthesize(
        fp, gen, [encoded], device=CPU, batch_size=1, max_mel_len=128, text_bucket=1,
        frame_bucket=32, dtype=BF16)
    (nb, mel_b, audio_b, _), (nf, mel_f, audio_f, _) = (
        run_jax(dt, dur_tgt=jnp.asarray(dur_tgt)) for dt in (jnp.bfloat16, None))
    assert mel.shape[0] == nb == nf and audio.shape == audio_b.shape == (nb * 16,)
    yardstick("text2wav mel", mel, mel_b, mel_f)
    yardstick("text2wav audio", audio, audio_b, audio_f)


# --------------------------------------------------------------------- training

def adam_grads(opt_state, b1):
    """The gradients of a first optax Adam step, from its first moment
    ``mu = (1 - b1) g`` (the state of any chain around the Adam)."""
    states = [x for x in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu"))
              if hasattr(x, "mu")]
    assert len(states) == 1, states
    return jax.tree_util.tree_map(lambda m: np.asarray(m) / (1.0 - b1), states[0].mu)


def grads_yardstick(what, port, jax_bf16, jax_f32):
    """One network's gradients (dicts by the port's parameter names) by the
    yardstick, twice: the whole gradient as one tensor, and each parameter's
    on its own, where the median over parameters must be within (a single
    leaf's max is noisy: the port's bf16 backward rounds at other places than
    XLA's, and its own bf16 error is up to twice JAX's at the MSD's deepest
    layers). Prints both and the leaf farthest past its bound."""
    assert sorted(port) == sorted(jax_bf16) == sorted(jax_f32), what
    ratios, e = [], np.zeros(3)
    for k in port:
        pb, jb, jf = (np.asarray(a[k], np.float64) for a in (port, jax_bf16, jax_f32))
        leaf = np.array([np.abs(pb - jb).max(), np.abs(jb - jf).max(), np.abs(jf).max()])
        e = np.maximum(e, leaf)
        bound = 2 * leaf[1] + 1e-3 * leaf[2]
        ratios.append((leaf[0] / bound if bound > 0 else float(leaf[0] > 0), k))
    bound = 2 * e[1] + 1e-3 * e[2]
    worst, median = max(ratios), float(np.median([r for r, _ in ratios]))
    print(f"bf16 {what}: whole gradient e_port {e[0]:.3e}, e_jax {e[1]:.3e} (bound {bound:.3e}); "
          f"{len(ratios)} parameters, median e_port / bound {median:.2f}, "
          f"{sum(r > 1 for r, _ in ratios)} past their own bound, the farthest {worst[1]} "
          f"({worst[0]:.2f})")
    assert e[0] <= bound, f"{what}: e_port {e[0]:.3e} > {bound:.3e} (e_jax {e[1]:.3e})"
    assert median <= 1.0, f"{what}: median e_port / bound {median:.2f} over the parameters"


def _param_bound(what, got, want, lr):
    d = max((got[k].double() - want[k].double()).abs().max().item() for k in want)
    print(f"bf16 {what}: max |port - JAX| after one step {d:.3e} (bound {2.5 * lr + 1e-6:.3e})")
    for k, v in want.items():
        diff = (got[k].double() - v.double()).abs().max().item()
        assert diff <= 2.5 * lr + 1e-6, f"{what} {k}: {diff:.3e}"


def test_fastpitch_trainer_step_bf16_matches_jax():
    from neuraltexttospeech_torch.cli.fastpitch_train import make_loss_fn
    from neuraltexttospeech_torch.models.fastpitch_loss import FastPitchLossConfig
    from neuraltexttospeech_torch.train import harness as port_harness
    from neuraltexttospeech_torch.train import state as port_state
    jax_loss = importlib.import_module("neuraltexttospeech_tpu.models.fastpitch_loss")
    from neuraltexttospeech_tpu.ops.prior import beta_binomial_prior
    from neuraltexttospeech_tpu.train import harness as jax_harness
    from neuraltexttospeech_tpu.train import state as jax_state

    kw = dict(n_symbols=40, symbols_embedding_dim=64, in_fft_n_layers=1, in_fft_d_head=16,
              in_fft_n_heads=2, in_fft_conv1d_filter_size=128, out_fft_n_layers=1,
              out_fft_d_head=16, out_fft_n_heads=2, out_fft_conv1d_filter_size=128,
              dur_predictor_filter_size=32, pitch_predictor_filter_size=32,
              energy_predictor_filter_size=32)
    kw.update({f.name: 0.0 for f in dataclasses.fields(port_fp.FastPitchConfig)
               if f.name.startswith("p_")})
    rng = np.random.default_rng(1)
    B, TT, TM = 3, 16, 48
    ilens, mlens = np.asarray([16, 10, 6], np.int32), np.asarray([48, 37, 20], np.int32)
    text = rng.integers(1, 40, (B, TT)).astype(np.int32)
    text[np.arange(TT)[None] >= ilens[:, None]] = 0
    valid = np.arange(TM)[None, :, None] < mlens[:, None, None]
    pitch = rng.standard_normal((B, 1, TM)).astype(np.float32)
    pitch[rng.uniform(size=pitch.shape) < 0.3] = 0.0
    batch = {"text": text, "input_lens": ilens, "mel_lens": mlens, "pitch": pitch,
             "mel": (rng.standard_normal((B, TM, 80)) * valid).astype(np.float32),
             "energy": np.abs(rng.standard_normal((B, TM))).astype(np.float32),
             "speaker": np.zeros(B, np.int32)}
    b0 = {k: jnp.asarray(v) for k, v in batch.items()}
    prior = beta_binomial_prior(b0["mel_lens"], b0["input_lens"], TM, TT)
    params = _np(jax.jit(jax_fp.FastPitch(jax_fp.FastPitchConfig(**kw)).init)(
        jax.random.PRNGKey(9), b0["text"], b0["input_lens"], b0["mel"], b0["mel_lens"],
        b0["pitch"], b0["energy"], None, prior))
    opt = dict(optimizer="adam", learning_rate=1e-3, eps=1e-6, beta1=0.9)

    def jax_step(dt):
        model = jax_fp.FastPitch(jax_fp.FastPitchConfig(**kw, dtype=dt))

        def loss_fn(p, b, key):
            pr = beta_binomial_prior(b["mel_lens"], b["input_lens"], b["mel"].shape[1],
                                     b["text"].shape[1])
            o = model.apply(p, b["text"], b["input_lens"], b["mel"], b["mel_lens"], b["pitch"],
                            b["energy"], None, pr, deterministic=False, rngs={"dropout": key})
            return jax_loss.fastpitch_loss(o, b["mel"], b["input_lens"], b["mel_lens"])

        trainer = jax_harness.Trainer(
            loss_fn, jax_state.TrainState.create(params, jax_state.make_optimizer(
                jax_state.OptimizerConfig(**opt))),
            jax_harness.TrainerConfig(optimizer=jax_state.OptimizerConfig(**opt),
                                      log_every=10 ** 9))
        metrics = {k: float(v) for k, v in trainer.train_step(batch).items()}
        grads = fastpitch_train_from_flax(adam_grads(trainer.state.opt_state, opt["beta1"]))
        return metrics, fastpitch_train_from_flax(_np(trainer.state.params)), grads

    (want_b, sd_b, g_b), (want_f, _, g_f) = jax_step(jnp.bfloat16), jax_step(None)
    model = port_fp.FastPitch(port_fp.FastPitchConfig(**kw))
    model.load_state_dict(fastpitch_train_from_flax(params))
    ours = port_harness.Trainer(
        make_loss_fn(FastPitchLossConfig(), n_speakers=1), model,
        port_harness.TrainerConfig(optimizer=port_state.OptimizerConfig(**opt),
                                   log_every=10 ** 9), "cpu", dtype=BF16)
    got = ours.train_step({k: torch.as_tensor(v) for k, v in batch.items()})
    assert sorted(got) == sorted(want_b)
    for k in want_b:
        yardstick(f"FastPitch step {k}", float(got[k]), want_b[k], want_f[k])
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    grads_yardstick("FastPitch step gradients",
                    {n: (m / (1.0 - opt["beta1"])).numpy()
                     for n, m in zip(names, ours.optimizer.mu)},
                    {n: g_b[n].numpy() for n in names}, {n: g_f[n].numpy() for n in names})
    sd = model.state_dict()
    assert all(v.dtype == torch.float32 for v in sd.values())
    _param_bound("FastPitch step parameters", sd, {k: sd_b[k] for k in sd}, opt["learning_rate"])
