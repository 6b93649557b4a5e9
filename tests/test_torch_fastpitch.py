"""The port's ``FastPitch.infer`` against the JAX module, same weights.

Narrow widths (d=64, 2 heads of 16, filters 128) at 2+2 layers and at the
full 6+6 layer structure. JAX-initialised params are converted with
``convert.fastpitch_from_flax``. Mel, pitch and durations agree to 1e-4 abs
(f32 on the CPU in both frameworks, sums in another order); ``dec_lens``
exactly. The batch has padded rows, and ``pace`` != 1 is covered.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraltexttospeech_torch.convert import fastpitch_from_flax
from neuraltexttospeech_torch.models import fastpitch as port_fp
from neuraltexttospeech_torch.nn.transformer import positional_embedding
from neuraltexttospeech_tpu.models import fastpitch as jax_fp
from neuraltexttospeech_tpu.nn import transformer as jax_tr

MAX_MEL = 160


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _kw(n_layers):
    return dict(n_symbols=40, symbols_embedding_dim=64,
                in_fft_n_layers=n_layers, out_fft_n_layers=n_layers,
                in_fft_n_heads=2, out_fft_n_heads=2, in_fft_d_head=16, out_fft_d_head=16,
                in_fft_conv1d_filter_size=128, out_fft_conv1d_filter_size=128,
                dur_predictor_filter_size=64, pitch_predictor_filter_size=64,
                energy_predictor_filter_size=64)


def _inputs():
    rng = np.random.default_rng(5)
    lens = np.array([24, 17, 9], np.int32)
    text = rng.integers(1, 40, (3, 24)).astype(np.int32)
    text[np.arange(24)[None, :] >= lens[:, None]] = 0  # padded rows
    return text, lens


@pytest.fixture(scope="module", params=[2, 6], ids=["2_layers", "6_layers"])
def models(request):
    kw = _kw(request.param)
    text, lens = _inputs()
    model = jax_fp.FastPitch(jax_fp.FastPitchConfig(**kw))
    params = model.init(jax.random.PRNGKey(request.param), jnp.asarray(text),
                        jnp.asarray(lens), max_mel_len=MAX_MEL, method=jax_fp.FastPitch.infer)
    params = jax.tree_util.tree_map(np.asarray, params)
    # about 3 frames per token, so the utterances have real lengths
    params["params"]["duration_predictor"]["Dense_0"]["bias"] = np.full((1,), np.log(4.0),
                                                                        np.float32)
    port = port_fp.FastPitch(port_fp.FastPitchConfig(**kw)).eval()
    port.load_state_dict(fastpitch_from_flax(params))
    return model, params, port


@pytest.mark.parametrize("pace", [1.0, 1.3])
def test_infer_matches_jax(models, pace):
    model, params, port = models
    text, lens = _inputs()
    ref = model.apply(params, jnp.asarray(text), jnp.asarray(lens), pace=pace,
                      max_mel_len=MAX_MEL, method=jax_fp.FastPitch.infer)
    with torch.no_grad():
        ours = port.infer(torch.as_tensor(text), torch.as_tensor(lens), pace=pace,
                          max_mel_len=MAX_MEL)
    mel, dec_lens, dur, pitch = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(ours[1].numpy(), dec_lens)
    assert 0 < dec_lens.min()
    np.testing.assert_allclose(ours[0].numpy(), mel, atol=1e-4, rtol=0)
    np.testing.assert_allclose(ours[2].numpy(), dur, atol=1e-4, rtol=0)
    np.testing.assert_allclose(ours[3].numpy(), pitch, atol=1e-4, rtol=0)


@pytest.mark.parametrize("pace", [1.0, 0.7, 1.5])
def test_regulate_len_matches_jax(pace):
    rng = np.random.default_rng(6)
    dur = rng.uniform(0, 6, (3, 11)).astype(np.float32)
    enc = rng.standard_normal((3, 11, 8)).astype(np.float32)
    ref_out, ref_lens = jax_fp.regulate_len(jnp.asarray(dur), jnp.asarray(enc), pace, 40)
    out, lens = port_fp.regulate_len(torch.as_tensor(dur), torch.as_tensor(enc), pace, 40)
    assert out.shape == (3, 40, 8)  # static max length, lengths clipped to it
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref_lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=1e-6)


@pytest.mark.parametrize("seq_len,dim", [(7, 16), (1024, 384)])
def test_positional_embedding_matches_jax(seq_len, dim):
    np.testing.assert_allclose(positional_embedding(seq_len, dim).numpy(),
                               np.asarray(jax_tr.positional_embedding(seq_len, dim)),
                               atol=1e-7)


def test_fully_padded_query_rows_stay_finite(models):
    _, _, port = models
    text = torch.zeros((2, 16), dtype=torch.long)
    text[0, :5] = 3
    with torch.no_grad():
        mel, dec_lens, _, _ = port.infer(text, None, max_mel_len=32)
    assert torch.isfinite(mel).all()
    assert dec_lens[1] == 0
