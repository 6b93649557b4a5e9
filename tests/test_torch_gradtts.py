"""The port's Grad-TTS synthesis (``models/gradtts.py``) against the JAX
package's, on the CPU, same weights and inputs.

- the committed ``gradtts`` golden (``tools/make_goldens.py:205-243``)
  through ``convert.gradtts_from_flax``: encoder mel, alignment and
  lengths at the goldens' 1e-5 (``atol = rtol = 1e-5``); every decoder mel
  here at 1e-5 of its size (``atol = 1e-5 max |JAX|``, ``rtol = 1e-5``).
  The score estimator agrees with JAX's to ~1e-6 of its size (its convs sum
  in another order: 3-4 ulp a block), and each Euler step multiplies the
  score by ``noise_t · h / 2`` (3.75 at the first of 2 steps), so the
  golden's mel, whose values reach 48, differs by up to 7.6e-5: under 2e-6
  of its size, but past ``1e-5 + 1e-5 |x|`` at 39 of its 5120 small
  elements;
- the ``gradtts2wav`` golden (``tools/make_goldens.py:451-524``), the
  reference's shipped composition, with the port's HiFi-GAN generator, the
  CLI's wiring (f32 host boundary, vocoder bucket, per-utterance trim): the
  lengths and audio at 1e-5, the decoder mel as above;
- the UNet's two padding traps against flax at odd and even sizes: the
  strided ``Conv((3, 3), (2, 2), "SAME")`` (pads (0, 1) on an even axis)
  and ``ConvTranspose((4, 4), (2, 2), "SAME", transpose_kernel=True)`` at
  non-square sizes: 1e-5;
- the stochastic sampler with JAX's per-step noise (its key splits
  reproduced here) fed in: 1e-5;
- the multi-speaker path (``tests/test_gradtts.py:109``) with the
  zero-initialised parameters (ReZero gains, the prenet's projection) made
  nonzero: 1e-5 (the decoder mel as above).

``pytest -s`` prints each comparison's largest difference.
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from neuraltexttospeech_torch.convert import generator_from_flax, gradtts_from_flax  # noqa: E402
from neuraltexttospeech_torch.models import gradtts as port_gt  # noqa: E402
from neuraltexttospeech_torch.models.hifigan import Generator, HiFiGANConfig  # noqa: E402
from neuraltexttospeech_tpu.models import gradtts as jax_gt  # noqa: E402
from tools.make_goldens import GOLDEN_DIR  # noqa: E402

# the goldens' small Grad-TTS (tools/make_goldens.py:211-213)
SMALL = dict(n_symbols=40, n_enc_channels=32, filter_channels=64, filter_channels_dp=32,
             n_enc_layers=2, dec_dim=8, out_size=16)
TINY_HG = dict(resblock="2", upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
               upsample_initial_channel=32, resblock_kernel_sizes=(3,),
               resblock_dilation_sizes=((1, 2),), n_fft=64, hop_size=16, win_size=64,
               num_mels=80)
B, TT, TM = 2, 11, 32


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(what, got, want, atol=1e-5, rtol=1e-5, sampled=False):
    """``sampled``: a decoder mel, held at 1e-5 of its size (docstring)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(want).all() and np.isfinite(got).all(), what
    if sampled:
        atol = 1e-5 * np.abs(want).max()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    print(f"{what}: max |port - JAX| {np.abs(got - want).max():.3e} (max |JAX| "
          f"{np.abs(want).max():.3e})")
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=what)


def _port(params, **cfg):
    model = port_gt.GradTTS(port_gt.GradTTSConfig(**cfg)).eval()
    model.load_state_dict(gradtts_from_flax(params))
    return model


def _restore(name):
    """A golden's committed variables, read without building the flax model."""
    from flax import serialization

    return serialization.msgpack_restore((GOLDEN_DIR / f"{name}.msgpack").read_bytes())


def random_params(model, seed, *args, **kwargs):
    """Random variables of the shapes ``model.init(*args, **kwargs)`` makes,
    drawn with numpy (no compiled init): kernels and embeddings N(0, 1/fan_in),
    norm scales 1 + N(0, 0.02²), every other leaf (biases, ReZero gains) N(0,
    0.02²), so that nothing flax zero-initialises stays zero. (Gains of 0.1
    make the linear attention's outputs reach ~400 and the sampled mel so
    ill-conditioned that either framework's f32 run is 1e-2 off a float64
    run of JAX's; at 0.02 the port is within 7e-5 of it and JAX's f32 within
    2e-4.)"""
    shapes = jax.eval_shape(lambda: model.init(*args, **kwargs))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(path[-1].key)
        if name in ("kernel", "embedding", "emb_rel_k", "emb_rel_v"):
            std = float(np.prod(leaf.shape[:-1])) ** -0.5
            return (rng.standard_normal(leaf.shape) * std).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.02 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _inputs(rng):
    """The goldens' text, lengths (and the mel draw they make next)."""
    x = rng.integers(1, 40, (B, TT)).astype(np.int32)
    rng.standard_normal((B, TM, 80))  # y, drawn before the noise
    return x, np.asarray([TT, 7], np.int32)


@pytest.fixture(scope="module")
def golden():
    params = _restore("gradtts")
    rng = np.random.default_rng(104)
    x, xl = _inputs(rng)
    noise = rng.standard_normal((B, 80, 32)).astype(np.float32)
    return params, x, xl, noise


def test_gradtts_golden_reproduces(golden):
    params, x, xl, noise = golden
    want = np.load(GOLDEN_DIR / "gradtts_golden.npz")
    enc, dec, attn, ylen = _port(params, **SMALL)(
        torch.as_tensor(x), torch.as_tensor(xl), 2, max_mel_len=32, noise=torch.as_tensor(noise))
    assert ylen.dtype == torch.int32
    for k, v in dict(enc=enc, dec=dec, attn=attn, ylen=ylen).items():
        _close(f"gradtts golden {k}", v.numpy(), want[k], sampled=k == "dec")


def test_gradtts2wav_golden_reproduces():
    from neuraltexttospeech_torch.utils.serving import round_up

    params = _restore("gradtts2wav")
    rng = np.random.default_rng(111)
    x, xl = _inputs(rng)
    noise = rng.standard_normal((B, 80, 32)).astype(np.float32)
    want = np.load(GOLDEN_DIR / "gradtts2wav_golden.npz")
    gen = Generator(HiFiGANConfig(**TINY_HG)).eval()
    gen.load_state_dict(generator_from_flax(params["hifigan"]))
    _, dec, _, ylen = _port(params["gradtts"], **SMALL)(
        torch.as_tensor(x), torch.as_tensor(xl), 2, max_mel_len=32, noise=torch.as_tensor(noise))
    dec = dec.float()
    M = min(round_up(int(ylen.max()), 16), 32)
    with torch.no_grad():
        audio = gen(dec[:, :M])[..., 0].numpy()
    _close("gradtts2wav golden dec", dec.numpy(), want["dec"], sampled=True)
    _close("gradtts2wav golden ylen", ylen.numpy(), want["ylen"])
    for r in range(B):
        _close(f"gradtts2wav golden audio_{r}", audio[r, :int(ylen[r]) * 16], want[f"audio_{r}"])


def _conv_weight(kernel):
    """A flax 2-D (transposed) conv kernel [Kh, Kw, a, b] → torch [b, a, Kh, Kw]."""
    return torch.as_tensor(np.asarray(kernel).transpose(3, 2, 0, 1).copy())


@pytest.mark.parametrize("H,W", [(80, 32), (10, 13), (9, 7), (4, 6)])
def test_downsampling_conv_matches_flax(H, W):
    x = jax.random.normal(jax.random.PRNGKey(H * W), (2, H, W, 3))
    conv = flax_nn.Conv(4, (3, 3), strides=(2, 2), padding="SAME")
    v = _np(conv.init(jax.random.PRNGKey(0), x))
    port = torch.nn.Conv2d(3, 4, 3, stride=2)
    port.load_state_dict({"weight": _conv_weight(v["params"]["kernel"]),
                          "bias": torch.as_tensor(v["params"]["bias"] + 0.1)})
    v["params"]["bias"] = v["params"]["bias"] + 0.1
    with torch.no_grad():
        got = port(port_gt.same_pad(torch.as_tensor(np.asarray(x)).permute(0, 3, 1, 2), 3, 2))
    want = np.asarray(conv.apply(v, x)).transpose(0, 3, 1, 2)
    assert got.shape[-2:] == (-(-H // 2), -(-W // 2))
    _close(f"downsampling conv {H}x{W}", got.numpy(), want)


@pytest.mark.parametrize("H,W", [(20, 8), (5, 7), (6, 3)])
def test_upsampling_conv_matches_flax(H, W):
    x = jax.random.normal(jax.random.PRNGKey(H + W), (2, H, W, 3))
    conv = flax_nn.ConvTranspose(4, (4, 4), strides=(2, 2), padding="SAME",
                                 transpose_kernel=True)
    v = _np(conv.init(jax.random.PRNGKey(0), x))
    v["params"]["bias"] = v["params"]["bias"] + 0.1
    port = torch.nn.ConvTranspose2d(3, 4, 4, stride=2, padding=1)
    port.load_state_dict({"weight": _conv_weight(v["params"]["kernel"]),
                          "bias": torch.as_tensor(v["params"]["bias"])})
    with torch.no_grad():
        got = port(torch.as_tensor(np.asarray(x)).permute(0, 3, 1, 2))
    want = np.asarray(conv.apply(v, x)).transpose(0, 3, 1, 2)
    assert got.shape[-2:] == (2 * H, 2 * W)
    _close(f"upsampling conv {H}x{W}", got.numpy(), want)


def _jax_step_noise(key, shape, steps):
    """The stochastic sampler's draws under ``GradTTS.__call__``'s key: the
    decoder gets the second half of ``split(key)``, then each step splits."""
    _, key = jax.random.split(key)
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(torch.as_tensor(np.asarray(jax.random.normal(sub, shape))))
    return out


def test_stochastic_sampler_matches_jax(golden):
    params, x, xl, noise = golden
    key = jax.random.PRNGKey(5)
    enc, dec, _, ylen = jax_gt.GradTTS(jax_gt.GradTTSConfig(**SMALL)).apply(
        params, x, xl, 3, stoc=True, temperature=1.3, max_mel_len=32, noise=noise, rng=key)
    got = _port(params, **SMALL)(torch.as_tensor(x), torch.as_tensor(xl), 3, stoc=True,
                                 temperature=1.3, max_mel_len=32, noise=torch.as_tensor(noise),
                                 step_noise=_jax_step_noise(key, (B, 80, 32), 3))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ylen))
    _close("stochastic sampler enc", got[0].numpy(), enc)
    _close("stochastic sampler dec", got[1].numpy(), dec, sampled=True)


def test_multi_speaker_matches_jax():
    cfg = jax_gt.GradTTSConfig(**dict(SMALL, n_spks=4, spk_emb_dim=8))
    model = jax_gt.GradTTS(cfg)
    rng = np.random.default_rng(3)
    x = rng.integers(1, 40, (B, TT)).astype(np.int32)
    xl = np.asarray([TT, 7], np.int32)
    noise = rng.standard_normal((B, 80, 48)).astype(np.float32)
    params = random_params(model, 4, jax.random.PRNGKey(0), x, xl, 1,
                           spk=np.zeros(B, np.int32), max_mel_len=48)
    synth = jax.jit(lambda p, spk: model.apply(p, x, xl, 2, spk=spk, max_mel_len=48,
                                               noise=noise))
    port = _port(params, **dict(SMALL, n_spks=4, spk_emb_dim=8))
    assert port.spk_emb is not None and port.decoder.estimator.spk_mlp is not None
    decs = []
    for ids in (np.asarray([1, 3], np.int32), np.asarray([2, 0], np.int32)):
        want = synth(params, ids)
        got = port(torch.as_tensor(x), torch.as_tensor(xl), 2, spk=torch.as_tensor(ids),
                   max_mel_len=48, noise=torch.as_tensor(noise))
        for name, g, w in zip(("enc", "dec", "attn", "ylen"), got, want):
            _close(f"multi-speaker {name} (speakers {ids})", g.numpy(), w,
                   sampled=name == "dec")
        decs.append(got[1])
    assert not torch.allclose(decs[0], decs[1])  # the speaker conditions the output


def test_helpers_match_jax():
    for n in (1, 3, 4, 17, 1000):
        assert port_gt.fix_len_compatibility(n) == jax_gt.fix_len_compatibility(n)
    dur = np.asarray([[2.0, 0.0, 3.0, 1.0], [1.0, 4.0, 0.0, 0.0]], np.float32)
    mask = np.ones((2, 4, 8), np.float32)
    mask[1, 2:] = 0.0
    np.testing.assert_array_equal(
        port_gt.generate_path(torch.as_tensor(dur), torch.as_tensor(mask)).numpy(),
        np.asarray(jax_gt.generate_path(jnp.asarray(dur), jnp.asarray(mask))))
    t = np.linspace(0.0, 1.0, 5, dtype=np.float32)
    for cum in (False, True):
        np.testing.assert_allclose(port_gt.get_noise(torch.as_tensor(t), 0.05, 20.0, cum).numpy(),
                                   jax_gt.get_noise(t, 0.05, 20.0, cum), rtol=1e-6)
