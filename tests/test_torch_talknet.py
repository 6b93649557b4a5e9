"""TalkNet 2's modules in the port against the JAX package, on the CPU.

- ``nn/layers.py::BatchNorm`` against flax's ``nn.BatchNorm``: the
  train-mode output and the updated ``mean``/``var`` (flax's ``mutable``
  result) at momentum 0.5 and 0.9, f32 and ``dtype=bf16``, and eval mode;
- QuartzNet's ASR (stride 2) and each TTS head, at the small config of
  ``tests/test_cli_smoke.py:343-348`` with random weights and BatchNorm
  statistics drawn with numpy: eval- and train-mode forwards at 1e-5 (JAX's
  dropout passed through by ``monkeypatch``, the port without a generator),
  and the BatchNorm buffers after the train-mode forward; under
  ``dtype=bf16`` each head by the bf16 yardstick of ``test_torch_bf16.py``,
  with its backbone computing in f32 as JAX's does;
- ``ctc_loss`` against JAX's at rtol 1e-5 (a row with repeated labels
  included), ``greedy_decode``, ``word_error_rate`` and ``StringMap``
  exactly, ``GaussianEmbedding`` with zero durations;
- the committed ``talknet`` golden (``tools/make_goldens.py::talknet``)
  through ``convert.talknet_from_flax`` at the goldens' 1e-5.

``pytest -s`` prints each comparison's largest difference.
"""

import contextlib
import pathlib
import sys
import types

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from neuraltexttospeech_torch.convert import quartznet_from_flax, talknet_from_flax  # noqa: E402
from neuraltexttospeech_torch.models import talknet as port_tn  # noqa: E402
from neuraltexttospeech_torch.nn.layers import BatchNorm  # noqa: E402
from neuraltexttospeech_tpu.models import talknet as jax_tn  # noqa: E402
from test_torch_bf16 import yardstick  # noqa: E402
from tools.make_goldens import GOLDEN_DIR  # noqa: E402

# tests/test_cli_smoke.py:343-348's overrides, on the default TalkNet2Config
BB = dict(module_repeat=1, block_params=((16, 5), (16, 5)), initial_filters=16,
          initial_kernel=5, penultimate_filters=16, penultimate_kernel=5, final_filters=32)
HEAD = dict(emb_dim=32)
HEADS = ("duration", "pitch", "spectrogram")
B, TT, TM = 2, 8, 40


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@contextlib.contextmanager
def jax_dropout_off():
    """JAX's ``talknet`` module with an ``nn`` whose ``Dropout`` passes its
    input through (the rate is a literal 0.1 there, always on in train mode);
    nothing in the JAX package changes."""
    view = types.SimpleNamespace(**{k: getattr(flax_nn, k) for k in dir(flax_nn)
                                    if not k.startswith("__")})
    view.Dropout = lambda rate: (lambda x, deterministic=True: x)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_tn, "nn", view)
        yield


def random_variables(model, seed, *args, **kwargs):
    """Random ``{"params", "batch_stats"}`` of the shapes ``model.init`` makes,
    drawn with numpy: kernels and embeddings N(0, 1/fan_in), BatchNorm scales
    1 + N(0, 0.1²), biases N(0, 0.1²), running means N(0, 0.1²) and running
    variances U(0.5, 2)."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args, **kwargs))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(path[-1].key)
        if name in ("kernel", "embedding"):
            std = float(np.prod(leaf.shape[:-1])) ** -0.5
            return (rng.standard_normal(leaf.shape) * std).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _close(what, got, want, atol=1e-5, rtol=1e-5):
    if torch.is_tensor(got):
        got = got.detach().float()
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all() and np.isfinite(want).all(), what
    print(f"{what}: max |port - JAX| {np.abs(got - want).max():.3e} (max |JAX| "
          f"{np.abs(want).max():.3e})")
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=what)


def _stats(sd):
    return {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


# ------------------------------------------------------------------ BatchNorm

@pytest.mark.parametrize("momentum, dtype", [(0.5, None), (0.9, None), (0.5, "bf16")])
def test_batchnorm_matches_flax(momentum, dtype):
    from neuraltexttospeech_torch.nn.precision import compute_dtype

    rng = np.random.default_rng(int(momentum * 10))
    x = (rng.standard_normal((3, 11, 6)) * 2.0 + 0.7).astype(np.float32)
    x[2, 7:] = 0.0  # padding counts in the statistics, in both
    jdt = jnp.bfloat16 if dtype else None
    bn = flax_nn.BatchNorm(momentum=momentum, dtype=jdt)
    v = {"params": {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
                    "bias": rng.standard_normal(6).astype(np.float32)},
         "batch_stats": {"mean": rng.standard_normal(6).astype(np.float32),
                         "var": rng.uniform(0.5, 2.0, 6).astype(np.float32)}}
    xin = jnp.asarray(x, jdt) if dtype else x
    y_train, mut = bn.apply(v, xin, use_running_average=False, mutable=["batch_stats"])
    y_eval = bn.apply(v, xin, use_running_average=True)

    ours = BatchNorm(6, momentum=momentum)
    start = {"weight": torch.as_tensor(v["params"]["scale"]),
             "bias": torch.as_tensor(v["params"]["bias"]),
             "running_mean": torch.as_tensor(v["batch_stats"]["mean"]),
             "running_var": torch.as_tensor(v["batch_stats"]["var"])}
    ours.load_state_dict(start)
    t = torch.as_tensor(x).transpose(1, 2)  # [B, C, T]
    tdt = torch.bfloat16 if dtype else None
    if tdt:
        t = t.to(tdt)
    with compute_dtype(tdt):
        got_train = ours(t).transpose(1, 2)
        assert ours.running_mean.dtype == ours.running_var.dtype == torch.float32
        for k, want in (("running_mean", mut["batch_stats"]["mean"]),
                        ("running_var", mut["batch_stats"]["var"])):
            _close(f"BatchNorm m={momentum} {dtype} {k}", getattr(ours, k), want)
        ours.load_state_dict(start)
        ours.eval()
        got_eval = ours(t).transpose(1, 2)
    for what, got, want in (("train", got_train, y_train), ("eval", got_eval, y_eval)):
        assert got.dtype == (torch.bfloat16 if dtype else torch.float32)
        assert want.dtype == (jnp.bfloat16 if dtype else jnp.float32)
        if dtype:  # one bf16 rounding of the same f32 value
            _close(f"BatchNorm {what} bf16", got, np.asarray(want, np.float32),
                   atol=1e-5, rtol=2 ** -8)
        else:
            _close(f"BatchNorm m={momentum} {what}", got, want)


# ------------------------------------------------------------- the networks

def _jax_models(dtype=None):
    bb = jax_tn.QuartzNetConfig(**BB)
    cfg = jax_tn.TalkNet2Config(**HEAD, backbone=bb, dtype=dtype)
    return {"asr": jax_tn.QuartzNet(29, bb), "duration": jax_tn.GraphemeDuration(cfg),
            "pitch": jax_tn.PitchPredictor(cfg), "spectrogram": jax_tn.SpectrogramModel(cfg)}


def _port_model(kind, dtype=None):
    bb = port_tn.QuartzNetConfig(**BB)
    if kind == "asr":
        return port_tn.QuartzNet(bb)
    cfg = port_tn.TalkNet2Config(**HEAD, backbone=bb, dtype=dtype)
    return {"duration": port_tn.GraphemeDuration, "pitch": port_tn.PitchPredictor,
            "spectrogram": port_tn.SpectrogramModel}[kind](cfg)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    text = rng.integers(1, 148, (B, TT)).astype(np.int32)
    lens = np.asarray([TT, 5], np.int32)
    text[1, 5:] = 0
    durs = rng.integers(0, 8, (B, TT)).astype(np.float32)
    durs[1, 5:] = 0
    return {"mel": rng.standard_normal((B, 64, 80)).astype(np.float32), "text": text,
            "lens": lens, "durs": durs, "f0": rng.standard_normal((B, TM)).astype(np.float32)}


def _args(kind, d):
    return {"asr": (d["mel"],), "duration": (d["text"], d["lens"]),
            "pitch": (d["text"], d["durs"], TM),
            "spectrogram": (d["text"], d["durs"], d["f0"], TM)}[kind]


def _torch_args(kind, d):
    return tuple(torch.as_tensor(a) if isinstance(a, np.ndarray) else a for a in _args(kind, d))


def _outputs(out):
    return [np.asarray(o, np.float32) for o in (out if isinstance(out, tuple) else (out,))]


@pytest.fixture(scope="module")
def jax_forwards():
    """Per model: its random variables, and JAX's eval-mode and train-mode
    (dropout off) outputs and updated statistics, one compile each; the
    heads also at ``dtype=bf16``, eval mode."""
    d = _inputs(0)
    out = {}
    with jax_dropout_off():
        for (kind, model), seed in zip(_jax_models().items(), range(10, 14)):
            args = _args(kind, d)
            static = tuple(i for i, a in enumerate(args) if isinstance(a, int))
            variables = random_variables(model, seed, *args)

            def run(v, *a, model=model):
                train, mut = model.apply(v, *a, train=True, mutable=["batch_stats"])
                return model.apply(v, *a), train, mut["batch_stats"]

            run = jax.jit(run, static_argnums=tuple(i + 1 for i in static))
            out[kind] = (variables, *run(variables, *args))
    for kind, model in _jax_models(jnp.bfloat16).items():
        if kind != "asr":
            args = _args(kind, d)
            out[kind + "_bf16"] = model.apply(out[kind][0], *args)
    return out


@pytest.mark.parametrize("kind", ["asr"] + list(HEADS))
def test_forward_eval_and_train_match_jax(kind, jax_forwards):
    variables, want_eval, want_train, want_stats = jax_forwards[kind]
    convert = quartznet_from_flax if kind == "asr" else talknet_from_flax
    ours = _port_model(kind)
    ours.load_state_dict(convert(variables))
    args = _torch_args(kind, _inputs(0))
    ours.eval()
    with torch.no_grad():
        got_eval = ours(*args)
    ours.train()
    with torch.no_grad():
        got_train = ours(*args)
    for mode, got, want in (("eval", got_eval, want_eval), ("train", got_train, want_train)):
        for i, (g, w) in enumerate(zip(_outputs(got), _outputs(want))):
            _close(f"{kind} {mode} output {i}", g, w)
    if kind == "asr":
        assert got_eval.shape == (B, 32, 29)  # stride 2: 64 frames → 32
    want_sd = convert({"params": variables["params"], "batch_stats": want_stats})
    got_stats = _stats(ours.state_dict())
    assert sorted(got_stats) == sorted(_stats(want_sd)) and got_stats
    for k, v in got_stats.items():
        _close(f"{kind} {k} after the train forward", v, want_sd[k])


@pytest.mark.parametrize("kind", HEADS)
def test_bf16_heads_match_jax_with_an_f32_backbone(kind, jax_forwards):
    variables, want_f32, _, _ = jax_forwards[kind]
    ours = _port_model(kind, torch.bfloat16)
    ours.load_state_dict(talknet_from_flax(variables))
    ours.eval()
    conv_types = set()
    hooks = [m.register_forward_hook(lambda m, i, o: conv_types.add(o.dtype))
             for m in ours.backbone.modules() if isinstance(m, torch.nn.Conv1d)]
    with torch.no_grad():
        got = ours(*_torch_args(kind, _inputs(0)))
    for h in hooks:
        h.remove()
    assert conv_types == {torch.float32}, conv_types  # the backbone's dtype is its own: f32
    for i, (g, wb, wf) in enumerate(zip(_outputs(got), _outputs(jax_forwards[kind + "_bf16"]),
                                        _outputs(want_f32))):
        assert g.dtype == np.float32
        yardstick(f"TalkNet 2 {kind} output {i}", g, wb, wf)


# ------------------------------------------------------------------ the ASR

def test_ctc_loss_matches_jax():
    rng = np.random.default_rng(3)
    T, C = 24, 29
    logp = jax.nn.log_softmax(rng.standard_normal((3, T, C)).astype(np.float32) * 3.0)
    logit_lens = np.asarray([24, 20, 13], np.int32)
    labels = np.asarray([[5, 3, 7, 9, 0, 0], [2, 2, 2, 4, 4, 0], [8, 1, 8, 0, 0, 0]],
                        np.int32)  # row 2 repeats labels (CTC needs a blank between)
    label_lens = np.asarray([4, 5, 3], np.int32)
    want = float(jax_tn.ctc_loss(logp, logit_lens, labels, label_lens))
    got = float(port_tn.ctc_loss(*(torch.as_tensor(np.array(a)) for a in
                                   (logp, logit_lens, labels, label_lens))))
    _close("ctc_loss", got, want, atol=0)


def test_greedy_decode_wer_and_string_map_match_jax():
    rng = np.random.default_rng(4)
    lp = rng.standard_normal((3, 30, 29)).astype(np.float32)
    lp[:, ::3, 0] += 4.0  # blanks
    lp[1, 10:14, 5] += 9.0  # a repeat collapsed
    lens = np.asarray([30, 17, 0], np.int32)
    assert (port_tn.greedy_decode(torch.as_tensor(lp), torch.as_tensor(lens))
            == jax_tn.greedy_decode(jnp.asarray(lp), jnp.asarray(lens)))
    refs = ["the cat sat on the mat", "hello world", "a b c", ""]
    hyps = ["the bat sat on mat", "hello there world", "", "extra words"]
    for r, h in zip(refs, hyps):
        assert port_tn.word_error_rate([r], [h]) == jax_tn.word_error_rate([r], [h])
    assert port_tn.word_error_rate(refs, hyps) == jax_tn.word_error_rate(refs, hyps)
    ours, ref = port_tn.StringMap(), jax_tn.StringMap()
    text = "Hello, World! It's 2 o'clock."
    assert len(ours) == len(ref) == port_tn.ASR_VOCAB == 29
    assert ours.encode(text) == ref.encode(text)
    assert ours.decode(ours.encode(text)) == ref.decode(ref.encode(text))
    assert ours.decode([0, 3, 0, 1, 29 - 1]) == ref.decode([0, 3, 0, 1, 29 - 1])


def test_gaussian_embedding_with_zero_durations_matches_jax():
    rng = np.random.default_rng(5)
    text = rng.integers(1, 10, (2, 5)).astype(np.int32)
    durs = np.asarray([[2.0, 0.0, 3.0, 1.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0]], np.float32)
    ge = jax_tn.GaussianEmbedding(n_symbols=10, emb_dim=4)
    params = random_variables(ge, 6, text, durs, 9)
    want = ge.apply(params, text, durs, 9)
    ours = port_tn.GaussianEmbedding(10, 4)
    ours.embed.weight.data = torch.as_tensor(params["params"]["Embed_0"]["embedding"])
    got = ours(torch.as_tensor(text), torch.as_tensor(durs), 9)
    _close("GaussianEmbedding, zero durations", got.detach(), want)


# ------------------------------------------------------------------ golden

def test_golden_matches():
    from flax import serialization

    variables = serialization.msgpack_restore((GOLDEN_DIR / "talknet.msgpack").read_bytes())
    want = np.load(GOLDEN_DIR / "talknet_golden.npz")["mel"]
    # tools/make_goldens.py::talknet: the config, then the inputs' draws
    bb = port_tn.QuartzNetConfig(block_repeat=1, module_repeat=2, block_params=((16, 5), (16, 7)),
                                 initial_filters=16, initial_kernel=5, penultimate_filters=16,
                                 penultimate_kernel=7, final_filters=32)
    model = port_tn.SpectrogramModel(port_tn.TalkNet2Config(n_symbols=30, emb_dim=16,
                                                            n_mel_channels=8, backbone=bb))
    model.load_state_dict(talknet_from_flax(variables))
    model.eval()
    rng = np.random.default_rng(107)
    text = torch.as_tensor(rng.integers(1, 30, (2, 6)).astype(np.int32))
    durs = torch.full((2, 6), 4.0)
    f0 = torch.as_tensor(rng.standard_normal((2, 24)).astype(np.float32))
    with torch.no_grad():
        got = model(text, durs, f0, 24)
    _close("golden talknet mel", got, want)


def test_conversion_raises_on_a_leaf_left_over():
    bb = jax_tn.QuartzNetConfig(**BB)
    v = random_variables(jax_tn.GraphemeDuration(jax_tn.TalkNet2Config(**HEAD, backbone=bb)), 1,
                         np.ones((1, 4), np.int32), np.asarray([4], np.int32))
    v["batch_stats"]["QuartzNet_0"]["extra"] = {"mean": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="unconsumed"):
        talknet_from_flax(v)
