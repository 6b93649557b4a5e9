"""Flowtron in the port against the JAX package, on the CPU.

- ``flip_by_lens`` exactly (ragged lengths, the padding left in place);
- at ``tests/test_flowtron.py``'s ``TINY`` with random weights drawn with
  numpy (``test_torch_talknet.random_variables``), through
  ``convert.flowtron_from_flax``: ``MaskedInstanceNorm`` with and without a
  mask, the text encoder, the mel encoder with the fixed and the learned
  ``GaussianMixture``, ``FlowtronAttention`` and both ``ARStep``s (density
  pass and ``infer``) at 1e-5; the committed ``flowtron`` golden at its
  1e-5; ``Flowtron``'s density pass with ragged lengths and ``infer`` on
  JAX's ``z`` within 1e-4; the port's own round trip ``infer(density(mel))
  ≈ mel`` at 2e-4, gate included; ``flowtron_loss`` on the same outputs at
  rtol 1e-6; the bf16 density pass and ``infer`` by the bf16 yardstick of
  ``test_torch_bf16.py`` against JAX compiled with XLA's excess precision
  off;
- 2 ``Trainer`` steps against 2 of the JAX ``Trainer`` (Adam with the CLI's
  clip, β2 and the step tests' eps: see ``EPS``; dropout off: JAX's by
  ``monkeypatch``, the port's loss given no generator): metrics at rtol
  2e-4, parameters at rtol 3e-3 / atol 3e-5; one bf16 step: metrics,
  gradients (JAX's from its Adam's first moment) and parameters by the
  yardstick;
- the configs and the CLIs' flags against the JAX package's; the serving
  loop on JAX's draws of ``z`` against JAX's ``infer`` and trim rule; and
  at a tiny width ``flowtron_train`` (2 steps, ``--resume`` for a 3rd equal
  to a straight 3-step run, validation, ``--amp``) then ``flowtron_infer``
  with a HiFi-GAN checkpoint, f32 and ``--amp``.

``pytest -s`` prints each comparison's largest difference.
"""

import contextlib
import dataclasses
import importlib
import json
import pathlib
import sys
import types
from concurrent.futures import ThreadPoolExecutor

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from neuraltexttospeech_torch.cli import flowtron_infer, flowtron_train  # noqa: E402
from neuraltexttospeech_torch.convert import flowtron_from_flax  # noqa: E402
from neuraltexttospeech_torch.models import flowtron as port_fl  # noqa: E402
from neuraltexttospeech_torch.train import harness as port_harness  # noqa: E402
from neuraltexttospeech_torch.train.state import OptimizerConfig  # noqa: E402
from neuraltexttospeech_tpu.models import flowtron as jax_fl  # noqa: E402
from test_flowtron import TINY  # noqa: E402
from test_torch_bf16 import _param_bound, adam_grads, grads_yardstick, yardstick  # noqa: E402
from test_torch_talknet import _close, random_variables  # noqa: E402
from tools.make_goldens import GOLDEN_DIR  # noqa: E402

B, TT, TM = 3, 9, 14
TEXT_LENS, MEL_LENS = [TT, 6, 3], [TM, 10, 5]
LR = 1e-3
# The step tests run Adam at eps 1e-5, not the CLI's 1e-8: the encoder
# convs' biases feed instance norms, which take out each channel's mean, so
# their gradients are zero but for rounding, and at eps 1e-8 Adam turns that
# rounding into steps of up to lr of either sign.
EPS = 1e-5
MIXTURE = {"fixed": dict(n_components=3, mean_scale=2.0),
           "learned": dict(n_components=3, fixed_gaussian=False)}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@contextlib.contextmanager
def jax_dropout_off():
    """JAX's ``flowtron`` module with an ``nn`` whose ``Dropout`` passes its
    input through; nothing in the JAX package changes."""
    view = types.SimpleNamespace(**{k: getattr(flax_nn, k) for k in dir(flax_nn)
                                    if not k.startswith("__")})
    view.Dropout = lambda rate, deterministic=None: (lambda x, deterministic=None: x)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_fl, "nn", view)
        yield


def port_config(config=TINY, dtype=None):
    """The port's ``FlowtronConfig`` with the fields of a JAX one."""
    return port_fl.FlowtronConfig(**{f.name: getattr(config, f.name)
                                     for f in dataclasses.fields(config) if f.name != "dtype"},
                                  dtype=dtype)


def batch(seed, n_mel=TINY.n_mel_channels):
    """A padded batch (numpy): text zero past its length, mels zero past
    theirs."""
    rng = np.random.default_rng(seed)
    lens, mel_lens = np.asarray(TEXT_LENS, np.int32), np.asarray(MEL_LENS, np.int32)
    text = rng.integers(1, TINY.n_text, (B, TT)).astype(np.int32)
    text[np.arange(TT)[None] >= lens[:, None]] = 0
    mel = rng.standard_normal((B, TM, n_mel)).astype(np.float32)
    mel[np.arange(TM)[None] >= mel_lens[:, None]] = 0.0
    return {"text": text, "input_lens": lens, "mel": mel, "mel_lens": mel_lens,
            "speaker": np.zeros(B, np.int32)}


def jax_variables(config=TINY, seed=1):
    b = batch(0, config.n_mel_channels)
    return random_variables(jax_fl.Flowtron(config), seed, b["mel"], b["speaker"], b["text"],
                            b["input_lens"], b["mel_lens"])


def port_model(variables, config=TINY, dtype=None):
    m = port_fl.Flowtron(port_config(config, dtype))
    m.load_state_dict(flowtron_from_flax(variables))
    return m


def _t(b):
    return {k: torch.as_tensor(np.array(v)) for k, v in b.items()}


def _np(tree):
    return jax.tree_util.tree_map(lambda x: None if x is None else np.asarray(x, np.float32),
                                  tree, is_leaf=lambda x: x is None)


def density(model, b):
    return model(b["mel"], b["speaker"], b["text"], b["input_lens"], b["mel_lens"])


def gate_target(mel_lens, T):
    return (np.arange(T)[None, :] >= (np.asarray(mel_lens)[:, None] - 1)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's density pass and ``infer`` at ``TINY`` for one draw of the
    weights, f32 and bf16 (bf16 compiled with XLA's excess precision off),
    each program compiled at once in threads; ``z`` for ``infer`` is JAX's
    ``N(0, 0.5²)`` draw."""
    variables = jax_variables()
    b = batch(2)
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(9), (B, TM, TINY.n_mel_channels))) * 0.5

    def run(dtype, what):
        model = jax_fl.Flowtron(dataclasses.replace(TINY, dtype=dtype))
        options = {} if dtype is None else {"xla_allow_excess_precision": False}
        if what == "density":
            fn = jax.jit(lambda v: model.apply(v, b["mel"], b["speaker"], b["text"],
                                               b["input_lens"], b["mel_lens"]),
                         compiler_options=options)
        else:
            fn = jax.jit(lambda v: model.apply(v, z, b["speaker"], b["text"], b["input_lens"],
                                               method=jax_fl.Flowtron.infer),
                         compiler_options=options)
        return _np(fn(variables))

    with ThreadPoolExecutor(4) as pool:
        jobs = {(dtype, what): pool.submit(run, dtype, what)
                for dtype in (None, jnp.bfloat16) for what in ("density", "infer")}
        return {"variables": variables, "batch": b, "z": z,
                **{k: f.result() for k, f in jobs.items()}}


# ------------------------------------------------------------------ modules

def test_flip_by_lens_is_exact():
    np.testing.assert_array_equal(
        port_fl.flip_by_lens(torch.tensor([[1.0, 2, 3, 0, 0]])[..., None],
                             torch.tensor([3]))[..., 0].numpy(), [[3, 2, 1, 0, 0]])
    x = np.random.default_rng(0).standard_normal((4, 7, 3)).astype(np.float32)
    lens = np.asarray([7, 4, 1, 0], np.int32)
    got = port_fl.flip_by_lens(torch.as_tensor(x), torch.as_tensor(lens)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_fl.flip_by_lens(x, lens)))
    np.testing.assert_array_equal(got[1, 4:], x[1, 4:])  # the padding stays
    np.testing.assert_array_equal(
        port_fl.flip_by_lens(torch.as_tensor(got), torch.as_tensor(lens)).numpy(), x)


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no_mask"])
def test_masked_instance_norm_matches_flax(masked):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((3, 11, 6)) * 2.0 + 0.7).astype(np.float32)
    mask = np.arange(11)[None] < np.asarray([11, 7, 1])[:, None] if masked else None
    norm = jax_fl.MaskedInstanceNorm()
    params = {"params": {"scale": (1 + 0.1 * rng.standard_normal(6)).astype(np.float32),
                         "bias": (0.1 * rng.standard_normal(6)).astype(np.float32)}}
    want = norm.apply(params, x, mask)
    ours = port_fl.MaskedInstanceNorm(6)
    ours.load_state_dict({"weight": torch.as_tensor(params["params"]["scale"]),
                          "bias": torch.as_tensor(params["params"]["bias"])})
    got = ours(torch.as_tensor(x), None if mask is None else torch.as_tensor(mask))
    _close(f"MaskedInstanceNorm ({'mask' if masked else 'no mask'})", got, want)


def test_text_encoder_attention_and_ar_steps_match_flax():
    variables = jax_variables()
    p = variables["params"]
    ours = port_model(variables)
    b = batch(4)
    tb = _t(b)
    enc = jax_fl.TextEmbeddingEncoder(TINY).apply({"params": p["encoder"]}, b["text"],
                                                  b["input_lens"])
    _close("text encoder", ours.encoder(tb["text"], tb["input_lens"]), enc)
    cond_dim = TINY.n_text_dim + TINY.n_speaker_dim
    rng = np.random.default_rng(5)
    cond = rng.standard_normal((B, TT, cond_dim)).astype(np.float32)
    queries = rng.standard_normal((B, TM, TINY.n_hidden)).astype(np.float32)
    key_mask = np.arange(TT)[None] < b["input_lens"][:, None]
    att = jax_fl.FlowtronAttention(TINY)
    att_p = {"params": p["flows_0"]["attention_layer"]}
    keys, values = att.apply(att_p, cond, method=att.project_text)
    want = att.apply(att_p, queries, keys, values, key_mask)
    layer = ours.flows[0].attention_layer
    with torch.no_grad():
        got = layer(torch.as_tensor(queries), *layer.project_text(torch.as_tensor(cond)),
                    torch.as_tensor(key_mask))
    for what, g, w in zip(("context", "weights"), got, want):
        _close(f"attention {what}", g, w)
    z = rng.standard_normal((B, TM, TINY.n_mel_channels)).astype(np.float32)
    for k in range(TINY.n_flows):
        step = jax_fl.ARStep(TINY, last_step=k == TINY.n_flows - 1)
        sp = {"params": p[f"flows_{k}"]}
        with torch.no_grad():
            got_d = ours.flows[k](tb["mel"], torch.as_tensor(cond), tb["input_lens"])
            got_i = ours.flows[k].infer(torch.as_tensor(z), torch.as_tensor(cond),
                                        tb["input_lens"])
        want_d = step.apply(sp, b["mel"], cond, b["input_lens"], b["mel_lens"])
        want_i = step.apply(sp, z, cond, b["input_lens"], method=step.infer)
        for what, g, w in zip(("z", "log_s", "gate", "attn"), got_d, want_d):
            if w is None:
                assert g is None, what
            else:
                _close(f"ARStep {k} density {what}", g, w)
        for what, g, w in zip(("mel", "gate", "attn"), got_i, want_i):
            _close(f"ARStep {k} infer {what}", g, w)


@pytest.mark.parametrize("kind", list(MIXTURE))
def test_mel_encoder_and_mixture_match_flax(kind):
    config = dataclasses.replace(TINY, **MIXTURE[kind])
    variables = jax_variables(config, seed=6)
    ours = port_model(variables, config)
    b = batch(7)
    want = jax_fl.Flowtron(config).apply(variables, b["mel"], b["speaker"], b["text"],
                                         b["input_lens"], b["mel_lens"])
    with torch.no_grad():
        got = density(ours, _t(b))
    for what in ("mean", "log_var", "prob", "z"):
        _close(f"{kind} mixture {what}", getattr(got, what), getattr(want, what))
    memb = jax_fl.MelEncoder(config).apply({"params": variables["params"]["mel_encoder"]},
                                           b["mel"], b["mel_lens"])
    _close(f"{kind} mel encoder", ours.mel_encoder(_t(b)["mel"], _t(b)["mel_lens"]), memb)


def test_golden_reproduces():
    """``tools/make_goldens.py:246-287``: the trained tiny Flowtron's density
    pass at the goldens' 1e-5."""
    from flax import serialization

    variables = serialization.msgpack_restore((GOLDEN_DIR / "flowtron.msgpack").read_bytes())
    golden = np.load(GOLDEN_DIR / "flowtron_golden.npz")
    rng = np.random.default_rng(105)
    text = rng.integers(1, 40, (2, 7)).astype(np.int32)
    mel = rng.standard_normal((2, 12, 8)).astype(np.float32)
    model = port_model(variables, TINY)
    with torch.no_grad():
        out = model(torch.as_tensor(mel), torch.zeros(2, dtype=torch.long),
                    torch.as_tensor(text), torch.tensor([7, 5]), torch.tensor([12, 9]))
    for k, got in (("z", out.z), ("log_s_sum", out.log_s_sum), ("gate", out.gate_out),
                   ("attn0", out.attns[0])):
        _close(f"golden {k}", got, golden[k])


# ------------------------------------------------------------- whole model

def test_density_pass_and_infer_match_jax(jax_runs):
    ours = port_model(jax_runs["variables"])
    tb = _t(jax_runs["batch"])
    with torch.no_grad():
        got = density(ours, tb)
        mel, gate, attns = ours.infer(torch.as_tensor(jax_runs["z"]), tb["speaker"], tb["text"],
                                      tb["input_lens"])
    want = jax_runs[None, "density"]
    for what in ("z", "log_s_sum", "gate_out"):
        _close(f"density {what}", getattr(got, what), getattr(want, what), atol=1e-4, rtol=1e-4)
    for k, (g, w) in enumerate(zip(got.attns, want.attns)):
        _close(f"density attention {k}", g, w, atol=1e-4, rtol=1e-4)
    want_mel, want_gate, want_attns = jax_runs[None, "infer"]
    _close("infer mel", mel, want_mel, atol=1e-4, rtol=1e-4)
    _close("infer gate", gate, want_gate, atol=1e-4, rtol=1e-4)
    for k, (g, w) in enumerate(zip(attns, want_attns)):
        _close(f"infer attention {k}", g, w, atol=1e-4, rtol=1e-4)


def test_round_trip_inverts_the_density_pass(jax_runs):
    """``tests/test_flowtron.py:63-74, 122-136`` on the port: full-length
    mels, so that ``infer``'s flips are the density pass's."""
    ours = port_model(jax_runs["variables"])
    tb = _t(jax_runs["batch"])
    tb["mel_lens"] = torch.full((B,), TM, dtype=torch.int32)
    with torch.no_grad():
        out = density(ours, tb)
        mel, gate, _ = ours.infer(out.z, tb["speaker"], tb["text"], tb["input_lens"])
    _close("round trip mel", mel, tb["mel"], atol=2e-4, rtol=0)
    _close("round trip gate", gate, out.gate_out, atol=2e-4, rtol=0)


@pytest.mark.parametrize("with_gate", [True, False], ids=["gate", "no_gate"])
def test_loss_matches_jax(jax_runs, with_gate):
    out = jax_runs[None, "density"]
    mel_lens = jax_runs["batch"]["mel_lens"]
    target = gate_target(mel_lens, TM) if with_gate else None
    want_loss, want = jax_fl.flowtron_loss(jax_fl.FlowtronOutput(*out), mel_lens, target,
                                           sigma=0.7)
    port_out = port_fl.FlowtronOutput(*(None if x is None else (
        tuple(torch.tensor(a) for a in x) if isinstance(x, tuple) else torch.tensor(x))
        for x in out))
    loss, got = port_fl.flowtron_loss(port_out, torch.as_tensor(mel_lens),
                                      None if target is None else torch.as_tensor(target),
                                      sigma=0.7)
    assert sorted(got) == sorted(want) and ("gate_loss" in got) == with_gate
    for k, v in want.items():
        print(f"loss {k}: port {float(got[k]):.8e}, JAX {float(v):.8e}")
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-6, err_msg=k)
    assert float(loss) == float(got["loss"])


def test_bf16_density_and_infer_match_jax(jax_runs):
    ours = port_model(jax_runs["variables"], dtype=torch.bfloat16)
    tb = _t(jax_runs["batch"])
    with torch.no_grad():
        got = density(ours, tb)
        mel, gate, attns = ours.infer(torch.as_tensor(jax_runs["z"]), tb["speaker"], tb["text"],
                                      tb["input_lens"])
    jb, jf = jax_runs[jnp.bfloat16, "density"], jax_runs[None, "density"]
    assert got.z.dtype == torch.float32 and got.gate_out.dtype == torch.bfloat16
    for what in ("z", "log_s_sum", "gate_out"):
        yardstick(f"Flowtron density {what}", getattr(got, what).float(), getattr(jb, what),
                  getattr(jf, what))
    yardstick("Flowtron density attention 0", got.attns[0].float(), jb.attns[0], jf.attns[0])
    (mb, gb, ab), (mf, gf, af) = jax_runs[jnp.bfloat16, "infer"], jax_runs[None, "infer"]
    yardstick("Flowtron infer mel", mel.float(), mb, mf)
    yardstick("Flowtron infer gate", gate.float(), gb, gf)
    yardstick("Flowtron infer attention 0", attns[0].float(), ab[0], af[0])


# ------------------------------------------------------------------ training

def jax_loss_fn(config):
    model = jax_fl.Flowtron(config)

    def loss_fn(params, b, rng):
        out = model.apply(params, b["mel"], b["speaker"], b["text"], b["input_lens"],
                          b["mel_lens"], deterministic=False, rngs={"dropout": rng})
        pos = jnp.arange(b["mel"].shape[1])[None, :]
        return jax_fl.flowtron_loss(out, b["mel_lens"],
                                    (pos >= b["mel_lens"][:, None] - 1).astype(jnp.float32))

    return loss_fn


OPT = dict(learning_rate=LR, grad_clip_norm=1.0, beta2=0.999, eps=EPS)


@pytest.fixture(scope="module")
def jax_steps():
    """The start weights; the JAX ``Trainer``'s two f32 steps (metrics and
    parameters after each) and one bf16 step of the same update (compiled
    with XLA's excess precision off; metrics, parameters and the clipped
    gradients from Adam's first moment), the two compiled at once."""
    from neuraltexttospeech_tpu.train import harness as jax_harness
    from neuraltexttospeech_tpu.train import state as jax_state

    start = jax_variables(seed=21)
    opt = jax_state.OptimizerConfig(**OPT)

    def f32():
        ref = jax_harness.Trainer(
            jax_loss_fn(TINY), jax_state.TrainState.create(start, jax_state.make_optimizer(opt)),
            jax_harness.TrainerConfig(optimizer=opt, log_every=10 ** 9))
        out = []
        for seed in (11, 12):
            metrics = {k: float(v) for k, v in ref.train_step(batch(seed)).items()}
            out.append((metrics, _np(ref.state.params), adam_grads(ref.state.opt_state, 0.9)))
        return out

    def bf16():
        tx = jax_state.make_optimizer(opt)
        loss_fn = jax_loss_fn(dataclasses.replace(TINY, dtype=jnp.bfloat16))

        def step(params, b):
            (_, meta), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                params, b, jax.random.PRNGKey(0))
            updates, opt_state = tx.update(grads, tx.init(params), params)
            return jax.tree_util.tree_map(jnp.add, params, updates), opt_state, meta

        params, opt_state, meta = jax.jit(step, compiler_options={
            "xla_allow_excess_precision": False})(start, batch(11))
        return {k: float(v) for k, v in meta.items()}, _np(params), adam_grads(opt_state, 0.9)

    with jax_dropout_off(), ThreadPoolExecutor(2) as pool:
        jobs = pool.submit(f32), pool.submit(bf16)
        return {"start": start, "f32": jobs[0].result(), "bf16": jobs[1].result()}


def port_trainer(variables, dtype=None):
    """A ``Trainer`` over the port model of ``variables``; its loss gets no
    generator (no dropout), as JAX's runs with dropout passed through."""
    loss_fn = flowtron_train.make_loss_fn()
    return port_harness.Trainer(lambda model, b, generator: loss_fn(model, b, None),
                                port_model(variables, dtype=dtype),
                                port_harness.TrainerConfig(optimizer=OptimizerConfig(**OPT),
                                                           log_every=10 ** 9), "cpu")


def test_trainer_steps_match_jax(jax_steps):
    ours = port_trainer(jax_steps["start"])
    first = {k: v.clone() for k, v in ours.model.state_dict().items()}
    for step, (seed, (want, params, _)) in enumerate(zip((11, 12), jax_steps["f32"]), 1):
        got = ours.train_step(_t(batch(seed)))
        assert sorted(got) == sorted(want), (sorted(got), sorted(want))
        for k, v in want.items():
            print(f"step {step} {k}: port {float(got[k]):.6e}, JAX {v:.6e}")
            np.testing.assert_allclose(float(got[k]), v, rtol=2e-4, err_msg=f"{step} {k}")
        sd, jax_sd = ours.model.state_dict(), flowtron_from_flax(params)
        assert sorted(sd) == sorted(jax_sd)
        print(f"step {step} parameters: max |port - JAX| "
              f"{max((sd[k] - jax_sd[k]).abs().max().item() for k in sd):.3e}")
        for k in sd:
            np.testing.assert_allclose(sd[k].numpy(), jax_sd[k].numpy(), rtol=3e-3, atol=3e-5,
                                       err_msg=f"step {step} {k}")
    for part in ("weight_hh", "affine_out", "embed", "norms"):  # the steps moved them
        assert max((sd[k] - first[k]).abs().max().item() for k in sd if part in k) > 1e-4, part


def test_amp_step_matches_jax_bf16_step(jax_steps):
    want_b, params_b, g_b = jax_steps["bf16"]
    want_f, _, g_f = jax_steps["f32"][0]
    ours = port_trainer(jax_steps["start"], torch.bfloat16)
    got = ours.train_step(_t(batch(11)))
    for k in want_b:
        yardstick(f"Flowtron step {k}", float(got[k]), want_b[k], want_f[k])
    names = [n for n, p in ours.model.named_parameters() if p.requires_grad]
    jb, jf = flowtron_from_flax(g_b), flowtron_from_flax(g_f)
    b1 = ours.optimizer.config.beta1
    grads_yardstick("Flowtron step gradients",
                    {n: (m / (1.0 - b1)).numpy() for n, m in zip(names, ours.optimizer.mu)},
                    {n: jb[n].numpy() for n in names}, {n: jf[n].numpy() for n in names})
    sd = ours.model.state_dict()
    assert all(v.dtype == torch.float32 for v in sd.values())
    _param_bound("Flowtron step parameters", sd, flowtron_from_flax(params_b), LR)


# ---------------------------------------------------------- configs and CLIs

def test_config_round_trip_matches_jax(tmp_path):
    from neuraltexttospeech_torch.models import registry as port_reg
    from neuraltexttospeech_tpu.models import registry as jax_reg

    items = ["n_hidden=64", "n_components=2", "fixed_gaussian=false", "scan_unroll=2"]
    want = jax_reg.apply_overrides(jax_fl.FlowtronConfig(dtype=jnp.bfloat16), items)
    got = port_reg.apply_overrides(port_fl.FlowtronConfig(dtype=torch.bfloat16), items)
    assert port_reg.config_to_dict(got) == jax_reg.config_to_dict(want)
    jax_reg.save_model_config(tmp_path, "Flowtron", want)
    assert port_reg.load_model_config(tmp_path) == ("Flowtron", dataclasses.replace(got,
                                                                                     dtype=None))
    port_reg.save_model_config(tmp_path / "p", "Flowtron", got)
    assert jax_reg.load_model_config(tmp_path / "p") == ("Flowtron",
                                                         dataclasses.replace(want, dtype=None))
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps({"train_config": {"epochs": 3},
                               "model_config": {"n_hidden": 64, "dtype": "x", "other": 1}}))
    assert flowtron_train.read_config(cfg, amp=True) == port_fl.FlowtronConfig(
        n_hidden=64, dtype=torch.bfloat16)


@pytest.mark.parametrize("cli, argv", [
    ("train", ["-o", "x", "-d", "y", "--training-files", "z", "--amp", "-c", "c.json",
               "--resume", "--validation-files", "v", "-bs", "4", "--sigma", "0.5",
               "--epochs-per-checkpoint", "2", "--steps-per-epoch", "3"]),
    ("inference", ["--checkpoint", "c", "-i", "i", "-o", "o", "--amp", "-bs", "2",
                   "--n-frames", "16", "--hifigan-checkpoint", "h", "--sigma", "0.5",
                   "--gate-threshold", "0.4", "--seed", "3", "--speaker", "1"]),
])
def test_cli_flags_parse_as_jax(cli, argv):
    jax_cli = importlib.import_module(f"flowtron.{cli}")
    ours = {"train": flowtron_train, "inference": flowtron_infer}[cli]
    ref, got = vars(jax_cli.parse_args(argv)), vars(ours.parse_args(argv))
    assert set(ref) <= set(got)
    assert all(got[k] == v for k, v in ref.items()), {k: (got[k], v) for k, v in ref.items()
                                                     if got[k] != v}


def test_serving_loop_on_jax_draws_matches_jax(jax_runs):
    """``synthesize`` given JAX's draws of ``z`` (``normal(fold_in(PRNGKey(seed),
    b))``) against JAX's ``infer`` on the same weights, trimmed by the JAX
    CLI's rule (flowtron/inference.py:121-127). The gate layer, scaled 20×
    and its bias set to -3.75, fires in one row at frame 0 (kept whole by
    the rule), in one never and in one at frame 8."""
    variables = jax.tree_util.tree_map(np.array, jax_runs["variables"])
    gate_layer = variables["params"]["flows_1"]["gate_layer"]
    gate_layer["kernel"] *= 20.0
    gate_layer["bias"][:] = -3.75
    model = jax_fl.Flowtron(TINY)
    rng = np.random.default_rng(8)
    encoded = [rng.integers(1, TINY.n_text, n).astype(np.int32) for n in (5, 9, 3)]
    sigma, seed, n_frames = 0.6, 4, TM

    def draws(b, shape):
        return jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(seed), b), shape)

    from neuraltexttospeech_torch.utils.serving import text_batches

    infer = jax.jit(lambda v, z, t, l: model.apply(v, z, jnp.zeros(2, jnp.int32), t, l,
                                                   method=jax_fl.Flowtron.infer)[:2])
    want = {}
    for b, (idxs, text, lens) in enumerate(text_batches(encoded, 2)):
        mel, gate = infer(variables, draws(b, (2, n_frames, 8)) * sigma, text, lens)
        gate_np = np.asarray(jax.nn.sigmoid(gate))
        for r, j in enumerate(idxs):
            stop = int(np.argmax(gate_np[r] > 0.5))
            n = stop if gate_np[r, stop] > 0.5 and stop > 0 else n_frames
            want[j] = np.asarray(mel[r, :n])
    ours = port_model(variables).eval()
    got = {j: mel for j, mel, audio in flowtron_infer.synthesize(
        ours, None, encoded, device=torch.device("cpu"), batch_size=2, n_frames=n_frames,
        sigma=sigma, seed=seed, noise=lambda b, shape: torch.tensor(np.asarray(draws(b,
                                                                                     shape))))}
    lengths = {j: len(w) for j, w in want.items()}
    print(f"serving loop: rows trimmed to {lengths} of {n_frames} frames")
    assert sorted(lengths.values()) == [8, n_frames, n_frames]
    assert sorted(got) == sorted(want) and {j: len(g) for j, g in got.items()} == lengths
    for j in want:
        _close(f"served mel {j}", got[j], want[j], atol=1e-4, rtol=1e-4)


TINY_CLI = {"n_text_dim": 32, "n_attn_channels": 16, "n_hidden": 24, "n_speaker_dim": 8}


def _train(feats, filelist, out, *extra):
    return flowtron_train.main(["-o", str(out), "-d", str(feats), "--training-files",
                                str(filelist), "-bs", "2", "--steps-per-epoch", "1",
                                "--device", "cpu", "-c", str(feats.parent / "tiny.json")]
                               + list(extra))


def _trained(out, step):
    return torch.load(out / "checkpoints" / str(step) / "train_state.pt",
                      weights_only=False)["trainer"]["model"]


def test_cli_train_resume_and_infer(tmp_path):
    from scipy.io import wavfile
    from test_torch_talknet_train import TINY_HG, _wavs

    from neuraltexttospeech_torch.models.hifigan import Generator, HiFiGANConfig
    from neuraltexttospeech_torch.models.registry import config_from_dict, save_checkpoint

    fl = _wavs(tmp_path, n=4)
    feats = tmp_path / "feats"
    (tmp_path / "tiny.json").write_text(json.dumps({"model_config": TINY_CLI}))
    straight = _train(feats, fl, tmp_path / "s", "--epochs", "3")
    _train(feats, fl, tmp_path / "r", "--epochs", "2", "--validation-files", str(fl))
    resumed = _train(feats, fl, tmp_path / "r", "--epochs", "3", "--resume")
    assert (straight["steps"], resumed["steps"], resumed["trainer"].step) == (3, 1, 3)
    assert sorted(resumed["metrics"]) == ["gate_loss", "grad_norm", "logdet", "loss", "nll",
                                          "steps_per_sec"]
    assert all(np.isfinite(v) for v in resumed["metrics"].values())
    a, b = _trained(tmp_path / "s", 3), _trained(tmp_path / "r", 3)
    for k, v in a.items():
        torch.testing.assert_close(b[k], v, rtol=0, atol=0, msg=k)
    amp = _train(feats, fl, tmp_path / "amp", "--epochs", "1", "--amp",
                 "--validation-files", str(fl))
    assert amp["config"].dtype == torch.bfloat16 and amp["steps"] == 1
    assert sorted(amp["val"]) == ["gate_loss", "logdet", "loss", "nll"]
    assert all(np.isfinite(v) for v in (*amp["metrics"].values(), *amp["val"].values()))
    cfg = json.loads((tmp_path / "r" / "checkpoints" / "3" / "model_config.json").read_text())
    assert cfg["model"] == "Flowtron" and cfg["config"]["n_hidden"] == 24
    assert "dtype" not in cfg["config"]

    hg_cfg = config_from_dict(HiFiGANConfig, TINY_HG)
    torch.manual_seed(0)
    hg = save_checkpoint(tmp_path / "hg", "HiFiGAN", hg_cfg, Generator(hg_cfg).state_dict())
    texts = ["Hello world.", "Another line of text to say.", "Third."]
    lines = tmp_path / "lines.txt"
    lines.write_text("\n".join(texts) + "\n")
    model = flowtron_infer.load_flowtron(tmp_path / "r", torch.device("cpu"))
    from neuraltexttospeech_torch.text.processing import TextProcessing

    tp = TextProcessing("english_basic", ["english_cleaners"], p_arpabet=0.0)
    encoded = [np.asarray(tp.encode_text(t), np.int32) for t in texts]
    want = {j: m for j, m, _ in flowtron_infer.synthesize(model, None, encoded,
                                                          device=torch.device("cpu"),
                                                          batch_size=2, n_frames=16, seed=3)}
    for tag, flags in (("f32", []), ("bf16", ["--amp"])):
        out = tmp_path / f"wavs_{tag}"
        flowtron_infer.main(["--checkpoint", str(tmp_path / "r" / "checkpoints"), "-i",
                             str(lines), "-o", str(out), "--hifigan-checkpoint", str(hg),
                             "--n-frames", "16", "-bs", "2", "--seed", "3", "--device", "cpu"]
                            + flags)
        for j in range(len(texts)):
            mel = np.load(out / f"utt_{j:04d}_mel.npy")
            sr, audio = wavfile.read(out / f"utt_{j:04d}.wav")
            assert mel.shape[1] == 80 and 0 < mel.shape[0] <= 16 and np.isfinite(mel).all()
            assert sr == 22050 and audio.shape == (mel.shape[0] * 16,)
            if tag == "f32":  # the CLI is the serving loop with the flags' seed
                np.testing.assert_array_equal(mel, want[j])
