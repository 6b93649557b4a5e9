"""The port's optimizers and generic trainer against optax and the JAX Trainer.

- ``train/state.py::Optimizer`` over adam/adamw/lamb × clipping on/off ×
  accumulation 1/2 × the constant/exponential/noam schedules: 5 calls from
  the same parameters and gradients as optax's ``make_optimizer`` (the JAX
  package's), parameters at rtol 1e-5 (f32; the port fuses some multiply-adds
  that optax rounds twice);
- ``train/harness.py::Trainer`` with the FastPitch loss of
  ``cli/fastpitch_train.py`` at the golden's small FastPitch, dropout off
  (p = 0), 1 and 2 steps against the JAX ``Trainer`` from the same weights
  and batches: metrics at rtol 2e-4, parameters at rtol 3e-3 / atol 3e-5
  (the gradients agree to about 1e-5 relative; Adam's first steps normalise
  them, so parameters with gradients near zero amplify that). Adam's eps is
  1e-6 here, not the default 1e-9: the attention's key bias has a gradient
  that is zero but for f32 rounding (softmax ignores a shift common to all
  keys), and with eps 1e-9 Adam turns that noise into steps of ±lr, of a
  sign neither framework determines;
- the per-step dropout generator is a function of ``(seed, step)``.
"""

import dataclasses
import importlib
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neuraltexttospeech_torch.cli.fastpitch_train import make_loss_fn
from neuraltexttospeech_torch.convert import fastpitch_train_from_flax
from neuraltexttospeech_torch.models import fastpitch as port_fp
from neuraltexttospeech_torch.models.fastpitch_loss import FastPitchLossConfig
from neuraltexttospeech_torch.train import harness as port_harness
from neuraltexttospeech_torch.train import state as port_state
from neuraltexttospeech_tpu.models import fastpitch as jax_fp
from neuraltexttospeech_tpu.train import harness as jax_harness
from neuraltexttospeech_tpu.train import state as jax_state

jax_loss = importlib.import_module("neuraltexttospeech_tpu.models.fastpitch_loss")

SHAPES = {"w": (7, 5), "b": (5,), "k": (3, 4, 2), "z": (4,)}  # "z" starts at 0 (lamb's ratio 1)
VARIANTS = list(itertools.product(["adam", "adamw", "lamb"], [None, 0.5], [1, 2],
                                  ["constant", "exponential", "noam"]))


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("opt,clip,accum,schedule", VARIANTS,
                         ids=["-".join(map(str, v)) for v in VARIANTS])
def test_optimizer_matches_optax(opt, clip, accum, schedule):
    rng = np.random.default_rng(len(opt) * 100 + accum * 10 + len(schedule))
    params = {k: (rng.standard_normal(s) if k != "z" else np.zeros(s)).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: (rng.standard_normal(s) * 3.0).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(5)]
    kw = dict(optimizer=opt, learning_rate=1e-2, weight_decay=0.1, grad_clip_norm=clip,
              grad_accum_steps=accum, schedule=schedule, decay_rate=0.5, decay_steps=2,
              warmup_steps=3)
    tx = jax_state.make_optimizer(jax_state.OptimizerConfig(**kw))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)

    @jax.jit
    def jax_step(g, state, p):
        updates, state = tx.update(g, state, p)
        return optax.apply_updates(p, updates), state

    tp = {k: torch.nn.Parameter(torch.as_tensor(v.copy())) for k, v in params.items()}
    ours = port_state.Optimizer(list(tp.values()), port_state.OptimizerConfig(**kw))
    for i, g in enumerate(grads):
        jp, jstate = jax_step({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        updated = ours.step([torch.as_tensor(g[k].copy()) for k in tp])
        assert updated == ((i + 1) % accum == 0)
        if i == len(grads) - 1:
            _report(f"{opt} clip={clip} accum={accum} {schedule}",
                    np.concatenate([tp[k].detach().numpy().ravel() for k in tp]),
                    np.concatenate([np.asarray(jp[k]).ravel() for k in tp]), rel=True)
        for k in tp:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"update {i}, {k}")
    assert ours.count == 5 // accum


def test_optimizer_state_round_trips():
    cfg = port_state.OptimizerConfig(optimizer="adamw", grad_accum_steps=2)
    p = [torch.nn.Parameter(torch.ones(3))]
    a = port_state.Optimizer(p, cfg)
    for _ in range(3):
        a.step([torch.full((3,), 0.5)])
    b = port_state.Optimizer([torch.nn.Parameter(torch.ones(3))], cfg)
    b.load_state_dict(a.state_dict())
    assert (b.count, b.mini_step) == (1, 1)
    for x, y in zip(a.mu + a.nu + a.acc, b.mu + b.nu + b.acc):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        port_state.Optimizer(p, port_state.OptimizerConfig()).load_state_dict(a.state_dict())
    with pytest.raises(ValueError):
        port_state.Optimizer(p, port_state.OptimizerConfig(optimizer="sgd"))


def test_step_generator_depends_on_seed_and_step():
    draw = [torch.rand(4, generator=port_harness.step_generator(s, t, "cpu"))
            for s, t in ((1, 0), (1, 0), (1, 1), (2, 0))]
    assert torch.equal(draw[0], draw[1])
    assert not torch.equal(draw[0], draw[2]) and not torch.equal(draw[0], draw[3])


TINY = dict(n_symbols=40, symbols_embedding_dim=64,
            in_fft_n_layers=1, in_fft_d_head=16, in_fft_n_heads=2,
            in_fft_conv1d_filter_size=128,
            out_fft_n_layers=1, out_fft_d_head=16, out_fft_n_heads=2,
            out_fft_conv1d_filter_size=128,
            dur_predictor_filter_size=32, pitch_predictor_filter_size=32,
            energy_predictor_filter_size=32)
NO_DROPOUT = {f.name: 0.0 for f in dataclasses.fields(port_fp.FastPitchConfig)
              if f.name.startswith("p_")}

def _report(what, got, want, rel=False):
    """Print the largest difference (``pytest -s`` shows it)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(got - want)
    if rel:
        d = d / np.maximum(np.abs(want), 1e-30)
    print(f"{what}: max {'relative ' if rel else ''}|port - reference| "
          f"{(d.max() if d.size else 0.0):.3e}")



def _batch(seed):
    rng = np.random.default_rng(seed)
    B, TT, TM = 3, 16, 48
    ilens = np.asarray([16, 10, 6], np.int32)
    mlens = np.asarray([48, 37, 20], np.int32)
    text = rng.integers(1, 40, (B, TT)).astype(np.int32)
    text[np.arange(TT)[None] >= ilens[:, None]] = 0
    valid = np.arange(TM)[None, :, None] < mlens[:, None, None]
    mel = (rng.standard_normal((B, TM, 80)) * valid).astype(np.float32)
    pitch = rng.standard_normal((B, 1, TM)).astype(np.float32)
    pitch[rng.uniform(size=pitch.shape) < 0.3] = 0.0
    return {"text": text, "input_lens": ilens, "mel": mel, "mel_lens": mlens, "pitch": pitch,
            "energy": np.abs(rng.standard_normal((B, TM))).astype(np.float32),
            "speaker": np.zeros(B, np.int32)}


def test_trainer_steps_match_jax_trainer():
    from neuraltexttospeech_tpu.ops.prior import beta_binomial_prior

    batches = [_batch(1), _batch(2)]
    jcfg = jax_fp.FastPitchConfig(**TINY, **NO_DROPOUT)
    model = jax_fp.FastPitch(jcfg)
    b0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
    prior0 = jax.jit(beta_binomial_prior, static_argnums=(2, 3))(
        b0["mel_lens"], b0["input_lens"], 48, 16)
    params = jax.jit(model.init)(jax.random.PRNGKey(9), b0["text"], b0["input_lens"],
                                 b0["mel"], b0["mel_lens"], b0["pitch"], b0["energy"], None,
                                 prior0)
    params = jax.tree_util.tree_map(np.asarray, params)

    def jax_loss_fn(p, batch, rng):
        prior = beta_binomial_prior(batch["mel_lens"], batch["input_lens"],
                                    batch["mel"].shape[1], batch["text"].shape[1])
        out = model.apply(p, batch["text"], batch["input_lens"], batch["mel"],
                          batch["mel_lens"], batch["pitch"], batch["energy"], None, prior,
                          deterministic=False, rngs={"dropout": rng})
        return jax_loss.fastpitch_loss(out, batch["mel"], batch["input_lens"],
                                       batch["mel_lens"])

    opt = dict(optimizer="adam", learning_rate=1e-3, eps=1e-6)
    ref = jax_harness.Trainer(
        jax_loss_fn, jax_state.TrainState.create(params, jax_state.make_optimizer(
            jax_state.OptimizerConfig(**opt))),
        jax_harness.TrainerConfig(optimizer=jax_state.OptimizerConfig(**opt),
                                  log_every=10 ** 9))

    port_model = port_fp.FastPitch(port_fp.FastPitchConfig(**TINY, **NO_DROPOUT))
    port_model.load_state_dict(fastpitch_train_from_flax(params))
    ours = port_harness.Trainer(
        make_loss_fn(FastPitchLossConfig(), n_speakers=1), port_model,
        port_harness.TrainerConfig(optimizer=port_state.OptimizerConfig(**opt),
                                   log_every=10 ** 9), "cpu")
    for step, batch in enumerate(batches, start=1):
        want = {k: float(v) for k, v in ref.train_step(batch).items()}
        got = ours.train_step({k: torch.as_tensor(v) for k, v in batch.items()})
        assert ours.step == ref.step == step
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            _report(f"trainer step {step} {k}", float(got[k]), v, rel=True)
            np.testing.assert_allclose(float(got[k]), v, rtol=2e-4, err_msg=f"step {step} {k}")
        jax_sd = fastpitch_train_from_flax(jax.tree_util.tree_map(np.asarray,
                                                                  ref.state.params))
        moved = 0.0
        _report(f"trainer step {step} parameters",
                np.concatenate([v.numpy().ravel() for v in port_model.state_dict().values()]),
                np.concatenate([jax_sd[k].numpy().ravel() for k in port_model.state_dict()]))
        for k, v in port_model.state_dict().items():
            np.testing.assert_allclose(v.numpy(), jax_sd[k].numpy(), rtol=3e-3, atol=3e-5,
                                       err_msg=f"step {step} {k}")
            moved = max(moved, float((v - fastpitch_train_from_flax(params)[k]).abs().max()))
        assert moved > 1e-4  # the steps did move the parameters
