"""FastPitch's training forward and losses: the port against JAX.

At the golden's small FastPitch (``tools/make_goldens.py:62-69``: d=64,
1+1 layers, 2 heads of 16, filters 128/32), f32 on the CPU in both
frameworks, dropout off (no generator here, ``deterministic=True`` there):

- the committed ``fastpitch`` golden (``fastpitch.msgpack`` through
  ``convert.fastpitch_train_from_flax``) reproduces ``fastpitch_golden.npz``
  at the goldens' 1e-5;
- every ``FastPitchOutput`` field from JAX-initialised weights agrees to
  1e-4 abs (the hard alignment and the masks exactly); ``average_pitch`` and
  ``ConvAttention`` alone agree to 1e-5;
- each term of ``fastpitch_loss`` on the same model outputs agrees at
  rtol 1e-4, and the CTC term's gradient too;
- dropout runs only with a generator and is reproducible from its seed.
"""

import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from neuraltexttospeech_torch.convert import fastpitch_from_flax, fastpitch_train_from_flax
from neuraltexttospeech_torch.models import fastpitch as port_fp
from neuraltexttospeech_torch.models import fastpitch_loss as port_loss
from neuraltexttospeech_tpu.models import fastpitch as jax_fp

# the JAX package's models/__init__ exports a function of the module's name
jax_loss = importlib.import_module("neuraltexttospeech_tpu.models.fastpitch_loss")

GOLDEN_DIR = pathlib.Path(__file__).resolve().parent / "fixtures" / "golden"
TINY = dict(n_symbols=40, symbols_embedding_dim=64,
            in_fft_n_layers=1, in_fft_d_head=16, in_fft_n_heads=2,
            in_fft_conv1d_filter_size=128,
            out_fft_n_layers=1, out_fft_d_head=16, out_fft_n_heads=2,
            out_fft_conv1d_filter_size=128,
            dur_predictor_filter_size=32, pitch_predictor_filter_size=32,
            energy_predictor_filter_size=32)
FIELDS = port_fp.FastPitchOutput._fields

def _report(what, got, want, rel=False):
    """Print the largest difference (``pytest -s`` shows it)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(got - want)
    if rel:
        d = d / np.maximum(np.abs(want), 1e-30)
    print(f"{what}: max {'relative ' if rel else ''}|port - reference| "
          f"{(d.max() if d.size else 0.0):.3e}")



@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def golden_inputs():
    """The inputs of ``tools/make_goldens.py::fastpitch``, drawn in its order."""
    rng = np.random.default_rng(100)
    B, TT, TM = 2, 13, 40
    text = rng.integers(1, 40, (B, TT)).astype(np.int32)
    ilens = np.asarray([TT, 9], np.int32)
    mel = rng.standard_normal((B, TM, 80)).astype(np.float32)
    mlens = np.asarray([TM, 30], np.int32)
    pitch = rng.standard_normal((B, 1, TM)).astype(np.float32)
    energy = np.abs(rng.standard_normal((B, TM)).astype(np.float32))
    prior = (np.abs(rng.standard_normal((B, TM, TT))) + 0.1).astype(np.float32)
    return text, ilens, mel, mlens, pitch, energy, prior


def batch_inputs():
    """Three utterances of 16-padded text with unvoiced (zero) pitch frames."""
    rng = np.random.default_rng(7)
    B, TT, TM = 3, 16, 64
    ilens = np.asarray([16, 11, 5], np.int32)
    mlens = np.asarray([64, 50, 23], np.int32)
    text = rng.integers(1, 40, (B, TT)).astype(np.int32)
    text[np.arange(TT)[None] >= ilens[:, None]] = 0
    mel = (rng.standard_normal((B, TM, 80)) * (np.arange(TM)[None, :, None]
                                               < mlens[:, None, None])).astype(np.float32)
    pitch = rng.standard_normal((B, 1, TM)).astype(np.float32)
    pitch[rng.uniform(size=pitch.shape) < 0.3] = 0.0
    energy = np.abs(rng.standard_normal((B, TM))).astype(np.float32)
    prior = np.zeros((B, TM, TT), np.float32)
    from neuraltexttospeech_torch.data.prior import beta_binomial_prior_distribution
    for b in range(B):
        prior[b, :mlens[b], :ilens[b]] = beta_binomial_prior_distribution(ilens[b], mlens[b])
    return text, ilens, mel, mlens, pitch, energy, prior


def _torch(args):
    return [None if a is None else torch.as_tensor(a) for a in args]


def _port_forward(model, args, **kw):
    text, ilens, mel, mlens, pitch, energy, prior = _torch(args)
    return model(text, ilens, mel, mlens, pitch, energy, None, prior, **kw)


@pytest.fixture(scope="module")
def models():
    """JAX TINY FastPitch (initialised on the batch) and the port with its
    weights."""
    args = batch_inputs()
    model = jax_fp.FastPitch(jax_fp.FastPitchConfig(**TINY))
    jargs = [jnp.asarray(a) for a in args]
    params = jax.jit(model.init)(jax.random.PRNGKey(3), *jargs[:6], None, jargs[6])
    params = jax.tree_util.tree_map(np.asarray, params)
    port = port_fp.FastPitch(port_fp.FastPitchConfig(**TINY))
    port.load_state_dict(fastpitch_train_from_flax(params))
    ref = jax.jit(model.apply)(params, *jargs[:6], None, jargs[6])
    return model, params, port, args, ref


def test_fastpitch_golden_reproduces_through_the_port():
    tree = serialization.msgpack_restore((GOLDEN_DIR / "fastpitch.msgpack").read_bytes())
    port = port_fp.FastPitch(port_fp.FastPitchConfig(**TINY))
    port.load_state_dict(fastpitch_train_from_flax(tree))
    with torch.no_grad():
        out = _port_forward(port, golden_inputs())
    golden = np.load(GOLDEN_DIR / "fastpitch_golden.npz")
    assert sorted(golden.files) == ["attn_soft", "dur_pred", "mel_out", "pitch_pred"]
    for k in golden.files:
        _report(f"golden {k}", getattr(out, k).numpy(), golden[k])
        np.testing.assert_allclose(getattr(out, k).numpy(), golden[k], atol=1e-5, rtol=1e-5,
                                   err_msg=k)


def test_training_forward_matches_jax(models):
    _, _, port, args, ref = models
    with torch.no_grad():
        out = _port_forward(port, args)
    for name in FIELDS:
        want, got = np.asarray(getattr(ref, name)), getattr(out, name).numpy()
        assert got.shape == want.shape, name
        _report(f"forward {name}", got, want)
        if name in ("attn_hard", "attn_hard_dur", "dec_mask"):
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=0, err_msg=name)
    # the alignment is real: every valid frame assigned, durations sum to the mel length
    np.testing.assert_array_equal(out.attn_hard_dur.sum(1).numpy(), args[3])


def test_losses_match_jax_on_the_same_outputs(models):
    _, _, _, args, ref = models
    _, ilens, mel, mlens = args[:4]
    want_loss, want = jax.jit(jax_loss.fastpitch_loss)(ref, jnp.asarray(mel),
                                                       jnp.asarray(ilens), jnp.asarray(mlens))
    outs = port_fp.FastPitchOutput(*[None if v is None else torch.as_tensor(np.asarray(v))
                                     for v in ref])
    loss, got = port_loss.fastpitch_loss(outs, torch.as_tensor(mel), torch.as_tensor(ilens),
                                         torch.as_tensor(mlens))
    assert sorted(got) == sorted(want)
    for k in want:
        _report(f"loss {k}", float(got[k]), float(want[k]), rel=True)
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    assert float(got["attn_loss"]) > 0 and float(got["kl_loss"]) > 0


def test_ctc_loss_and_gradient_match_optax():
    rng = np.random.default_rng(11)
    B, T_mel, T_text = 3, 30, 12
    in_lens, out_lens = np.array([12, 7, 3]), np.array([30, 19, 8])
    logprob = rng.standard_normal((B, T_mel, T_text)).astype(np.float32)

    def jax_fn(x):
        return jax_loss.attention_ctc_loss(x, jnp.asarray(in_lens), jnp.asarray(out_lens))

    want, want_g = jax.jit(jax.value_and_grad(jax_fn))(jnp.asarray(logprob))
    x = torch.as_tensor(logprob).requires_grad_()
    got = port_loss.attention_ctc_loss(x, torch.as_tensor(in_lens), torch.as_tensor(out_lens))
    got.backward()
    _report("ctc loss", float(got), float(want), rel=True)
    _report("ctc gradient", x.grad.numpy(), np.asarray(want_g))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(want_g)).max())


def test_average_pitch_matches_jax():
    rng = np.random.default_rng(4)
    pitch = rng.standard_normal((3, 2, 50)).astype(np.float32)
    pitch[rng.uniform(size=pitch.shape) < 0.4] = 0.0
    durs = rng.integers(0, 6, (3, 9)).astype(np.float32)
    durs[1, 4:] = 0  # spans with no frames average to 0
    want = np.asarray(jax_fp.average_pitch(jnp.asarray(pitch), jnp.asarray(durs)))
    got = port_fp.average_pitch(torch.as_tensor(pitch), torch.as_tensor(durs)).numpy()
    _report("average_pitch", got, want)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert (got[1, :, 4:] == 0).all()


@pytest.mark.parametrize("with_prior", [False, True])
def test_conv_attention_matches_jax(with_prior):
    rng = np.random.default_rng(5)
    mel = rng.standard_normal((2, 21, 8)).astype(np.float32)
    keys = rng.standard_normal((2, 9, 16)).astype(np.float32)
    mask = np.arange(9)[None] < np.array([9, 6])[:, None]
    prior = rng.uniform(0.01, 1, (2, 21, 9)).astype(np.float32) if with_prior else None
    att = jax_fp.ConvAttention(n_mel_channels=8, n_text_channels=16, n_attn_channels=4)
    jprior = None if prior is None else jnp.asarray(prior)
    params = jax.jit(att.init)(jax.random.PRNGKey(0), jnp.asarray(mel), jnp.asarray(keys),
                               jnp.asarray(mask), jprior)
    want = jax.jit(att.apply)(params, jnp.asarray(mel), jnp.asarray(keys), jnp.asarray(mask),
                              jprior)
    port = port_fp.ConvAttention(8, 16, 4)
    convs = params["params"]
    with torch.no_grad():
        for i, name in enumerate(("key_conv1", "key_conv2", "query_conv1", "query_conv2",
                                  "query_conv3")):
            conv = getattr(port, name)
            conv.weight.copy_(torch.as_tensor(np.asarray(convs[f"Conv_{i}"]["kernel"])
                                              .transpose(2, 1, 0)))
            conv.bias.copy_(torch.as_tensor(np.asarray(convs[f"Conv_{i}"]["bias"])))
        got = port(torch.as_tensor(mel), torch.as_tensor(keys), torch.as_tensor(mask),
                   None if prior is None else torch.as_tensor(prior))
    for g, w in zip(got, want):
        _report("ConvAttention", g.numpy(), np.asarray(w))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)
    assert (got[0][1, :, 6:] == 0).all()  # masked keys get no attention


def test_dropout_runs_only_with_a_generator(models):
    _, _, port, args, _ = models
    cfg = port_fp.FastPitchConfig(**TINY)
    assert cfg.p_in_fft_dropout > 0
    with torch.no_grad():
        plain = _port_forward(port, args)
        port.train()
        still_plain = _port_forward(port, args)  # train mode alone does not drop
        port.eval()
        runs = [_port_forward(port, args, generator=torch.Generator().manual_seed(s))
                for s in (1, 1, 2)]
    torch.testing.assert_close(still_plain.mel_out, plain.mel_out, rtol=0, atol=0)
    torch.testing.assert_close(runs[0].mel_out, runs[1].mel_out, rtol=0, atol=0)
    assert not torch.equal(runs[0].mel_out, plain.mel_out)
    assert not torch.equal(runs[0].mel_out, runs[2].mel_out)
    # the aligner has no dropout: the soft attention is the same with and without
    torch.testing.assert_close(runs[0].attn_soft, plain.attn_soft, rtol=0, atol=0)


def test_train_converter_takes_the_aligner_and_serving_dicts_still_load(models):
    _, params, port, _, _ = models
    sd = fastpitch_train_from_flax(params)
    assert {k for k in sd if k.startswith("attention.")} == {
        f"attention.{n}.{w}" for n in ("key_conv1", "key_conv2", "query_conv1",
                                        "query_conv2", "query_conv3")
        for w in ("weight", "bias")}
    bad = jax.tree_util.tree_map(lambda x: x, params)
    bad["params"]["attention"]["Conv_9"] = {"kernel": np.zeros((1, 1, 1), np.float32)}
    with pytest.raises(ValueError, match="unconsumed"):
        fastpitch_train_from_flax(bad)
    # a serving dict has no aligner: it loads and leaves the aligner as it is
    serving = fastpitch_from_flax(params)
    assert not any(k.startswith("attention.") for k in serving)
    fresh = port_fp.FastPitch(port_fp.FastPitchConfig(**TINY))
    before = fresh.attention.key_conv1.weight.clone()
    fresh.load_state_dict(serving)
    assert torch.equal(fresh.attention.key_conv1.weight, before)
    torch.testing.assert_close(fresh.proj.weight, port.proj.weight, rtol=0, atol=0)
    serving.pop("proj.weight")
    with pytest.raises(RuntimeError, match="proj.weight"):
        fresh.load_state_dict(serving)
