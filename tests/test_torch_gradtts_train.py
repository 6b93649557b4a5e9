"""Grad-TTS training in the port against the JAX package, on the CPU.

From the committed ``gradtts`` golden's weights (``tools/make_goldens.py:205-243``,
read without a flax init), its inputs and the same numpy-seeded batches:

- ``duration_loss`` at rtol 1e-6; ``Diffusion.forward_diffusion`` and
  ``loss_t`` on given ``t``/``z`` at 1e-5;
- the segment cut (``cut_offsets``/``cut_segments``) on given ``u`` equal to
  JAX's vmapped ``dynamic_slice`` exactly, and the no-cut branch
  (``out_size >= T_mel``) through ``compute_loss``;
- the Gaussian log-prior at rtol 1e-5 of JAX's, then MAS on JAX's own
  log-prior equal to JAX's path exactly, printing the smallest margin of
  the Viterbi comparisons (a near-tie would show there);
- ``GradTTS.compute_loss`` with JAX's draws (its key split as JAX splits
  it) at rtol 2e-4;
- 1 and 2 ``Trainer`` steps (``cli/gradtts_train.make_loss_fn``) against
  the JAX ``Trainer`` with ``gradtts/train.py``'s optimizer (Adam at lr
  1e-4, clip 1.0, b2 0.999; eps 1e-6, see ``OPT``): each step's ``u``,
  ``t`` and ``z`` are JAX's (its per-step key ``fold_in(key(seed, "rbg"),
  step)``), fed through the batch; metrics at rtol 2e-4, parameters at
  rtol 3e-3 / atol 3e-5;
- one bf16 step (``--amp``) by the yardstick of ``test_torch_bf16.py``,
  gradients included, against JAX's bf16 step compiled with every bf16 op
  rounded to bf16 (:func:`round_every_bf16_op`; XLA's CPU backend otherwise
  keeps f32 between fused ops, which the card's bf16 kernels do not);
- the CLI at a tiny size: ``gradtts_train`` for 2 epochs equals 1 epoch then
  ``--resume`` bit for bit, ``--amp`` trains, ``gradtts_infer`` loads the
  result; every JAX flag parses to the same value.

JAX's ``compute_loss`` always drops out, and two of its dropouts have fixed
rates (the prenet's 0.5 and the duration predictor's 0.1); the parity tests
set them to 0 for JAX's modules (``monkeypatch`` of the two classes, with
``enc_dropout=0``) and run the port without dropout. ``pytest -s`` prints
each comparison's largest difference.
"""

import functools
import pathlib
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from neuraltexttospeech_torch.cli import gradtts_infer, gradtts_train  # noqa: E402
from neuraltexttospeech_torch.convert import gradtts_from_flax  # noqa: E402
from neuraltexttospeech_torch.models import gradtts as port_gt  # noqa: E402
from neuraltexttospeech_torch.ops import mas as port_mas  # noqa: E402
from neuraltexttospeech_torch.train import harness as port_harness  # noqa: E402
from neuraltexttospeech_torch.train import state as port_state  # noqa: E402
from neuraltexttospeech_tpu.models import gradtts as jax_gt  # noqa: E402
from neuraltexttospeech_tpu.ops import mas as jax_mas  # noqa: E402
from neuraltexttospeech_tpu.train import harness as jax_harness  # noqa: E402
from neuraltexttospeech_tpu.train import state as jax_state  # noqa: E402
from test_torch_bf16 import _param_bound, adam_grads, grads_yardstick, yardstick  # noqa: E402
from tools.make_goldens import GOLDEN_DIR  # noqa: E402

# the golden's small Grad-TTS (tools/make_goldens.py:211-213), dropout off
SMALL = dict(n_symbols=40, n_enc_channels=32, filter_channels=64, filter_channels_dp=32,
             n_enc_layers=2, dec_dim=8, out_size=16, enc_dropout=0.0)
# gradtts/train.py's optimizer (lr 1e-4, clip 1, b2 0.999) with Adam's eps
# at 1e-6, not 1e-8, as in test_torch_fastpitch_optim.py: the small UNet
# (dec_dim 8, 8 groups) has one channel a GroupNorm group, so the conv biases
# before its GroupNorms have a gradient of exactly 0 but for rounding, and at
# eps 1e-8 Adam turns each framework's rounding noise there into steps of up
# to lr (2.5e-5 apart after 2 steps; 2.2e-7 at eps 1e-6)
OPT = dict(learning_rate=1e-4, grad_clip_norm=1.0, beta1=0.9, beta2=0.999, eps=1e-6)
SEED = 37
B, TT, TM = 2, 11, 32


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True, scope="module")
def _jax_without_fixed_dropout():
    """JAX's prenet and duration predictor with their fixed dropout rates
    set to 0 (the parity runs compare deterministic losses)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_gt, "ConvReluNormPrenet",
               functools.partial(jax_gt.ConvReluNormPrenet, dropout=0.0))
    mp.setattr(jax_gt, "DurationPredictor",
               functools.partial(jax_gt.DurationPredictor, p_dropout=0.0))
    yield
    mp.undo()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(what, got, want, atol=1e-5, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all() and np.isfinite(want).all(), what
    print(f"{what}: max |port - JAX| {np.abs(got - want).max():.3e} (max |JAX| "
          f"{np.abs(want).max():.3e})")
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=what)


@pytest.fixture(scope="module")
def golden_params():
    from flax import serialization

    return serialization.msgpack_restore((GOLDEN_DIR / "gradtts.msgpack").read_bytes())


def _inputs(seed=104, t_mel=TM, y_lens=(TM, 24)):
    """The golden's text, lengths and mel draw (``tools/make_goldens.py:214-219``)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(1, 40, (B, TT)).astype(np.int32)
    xl = np.asarray([TT, 7], np.int32)
    y = rng.standard_normal((B, t_mel, 80)).astype(np.float32)
    return {"text": x, "input_lens": xl, "mel": y, "mel_lens": np.asarray(y_lens, np.int32)}


def _port(params):
    model = port_gt.GradTTS(port_gt.GradTTSConfig(**SMALL))
    model.load_state_dict(gradtts_from_flax(params))
    model.encoder.prenet.p_dropout = 0.0
    model.encoder.proj_w.p_dropout = 0.0
    return model


def _t(batch):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def jax_draws(rng, batch_size, t_mel, out_size, n_feats=80):
    """``u`` (None without a cut), ``t`` and ``z`` as ``GradTTS.compute_loss``
    draws them from ``rng``."""
    u = None
    if out_size is not None and out_size < t_mel:
        cut_rng, rng = jax.random.split(rng)
        u = jax.random.uniform(cut_rng, (batch_size,))
        t_mel = out_size
    t_rng, z_rng = jax.random.split(rng)
    t = jax.random.uniform(t_rng, (batch_size,), minval=1e-5, maxval=1.0 - 1e-5)
    z = jax.random.normal(z_rng, (batch_size, n_feats, t_mel))
    return {k: torch.as_tensor(np.array(v)) for k, v in (("u", u), ("t", t), ("z", z))
            if v is not None}


# ---------------------------------------------------------------- pieces

def test_duration_loss_matches_jax():
    rng = np.random.default_rng(0)
    logw, logw_hat = rng.standard_normal((2, 3, 17)).astype(np.float32)
    lens = np.asarray([17, 9, 4], np.int32)
    want = float(jax_gt.duration_loss(jnp.asarray(logw), jnp.asarray(logw_hat), jnp.asarray(lens)))
    got = float(port_gt.duration_loss(*map(torch.as_tensor, (logw, logw_hat, lens))))
    _close("duration_loss", got, want, atol=0, rtol=1e-6)


def test_forward_diffusion_and_loss_t_match_jax(golden_params):
    c = jax_gt.GradTTSConfig(**SMALL)
    rng = np.random.default_rng(3)
    x0 = rng.standard_normal((B, 80, 16)).astype(np.float32)
    mu = rng.standard_normal((B, 80, 16)).astype(np.float32)
    mask = np.arange(16)[None] < np.asarray([16, 9])[:, None]
    t = np.asarray([0.03, 0.71], np.float32)
    z_key = jax.random.PRNGKey(5)
    z = np.asarray(jax.random.normal(z_key, x0.shape))
    dec = {"params": golden_params["params"]["decoder"]}
    diff = jax_gt.Diffusion(c)
    want_xt, want_z = diff.apply(dec, x0, mask, mu, t, z_key,
                                 method=jax_gt.Diffusion.forward_diffusion)
    want_loss, _ = jax.jit(lambda: diff.apply(dec, x0, mask, mu, t, z_key,
                                              method=jax_gt.Diffusion.loss_t))()
    model = _port(golden_params)
    args = [torch.as_tensor(np.array(a)) for a in (x0, mask, mu, t, z)]
    got_xt, got_z = model.decoder.forward_diffusion(*args)
    _close("forward_diffusion x_t", got_xt.numpy(), want_xt)
    _close("forward_diffusion z", got_z.numpy(), want_z)
    got_loss, _ = model.decoder.loss_t(*args)
    _close("loss_t", got_loss.item(), want_loss, atol=0)


@pytest.mark.parametrize("y_lens", [(32, 24), (20, 3), (16, 32)])
def test_segment_cut_matches_jax(y_lens):
    out_size = 16
    rng = np.random.default_rng(sum(y_lens))
    y = rng.standard_normal((2, 32, 80)).astype(np.float32)
    attn = rng.standard_normal((2, 11, 32)).astype(np.float32)
    ylen = np.asarray(y_lens, np.int32)
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(sum(y_lens)), (2,)))
    # JAX's cut (gradtts.py:602-621)
    max_offset = jnp.maximum(ylen - out_size, 0)
    off = (u * (max_offset + 1).astype(jnp.float32)).astype(jnp.int32)
    want_y = jax.vmap(lambda a, o: jax.lax.dynamic_slice(a, (o, 0), (out_size, 80)))(y, off)
    want_a = jax.vmap(lambda a, o: jax.lax.dynamic_slice(a, (0, o), (11, out_size)))(attn, off)
    got_off = port_gt.cut_offsets(torch.as_tensor(u), torch.as_tensor(ylen), out_size)
    np.testing.assert_array_equal(got_off.numpy(), np.asarray(off))
    np.testing.assert_array_equal(
        port_gt.cut_segments(torch.as_tensor(y), got_off, out_size, dim=1).numpy(), want_y)
    np.testing.assert_array_equal(
        port_gt.cut_segments(torch.as_tensor(attn), got_off, out_size, dim=2).numpy(), want_a)


def _jax_model():
    return jax_gt.GradTTS(jax_gt.GradTTSConfig(**SMALL))


def test_log_prior_matches_jax_and_mas_on_it_exactly(golden_params):
    batch = _inputs()
    model = _jax_model()
    mu_x, _, _ = jax.jit(lambda p: model.apply(p, batch["text"], batch["input_lens"],
                                               method=lambda m, x, l: m.encoder(x, l)))(
        golden_params)
    y = batch["mel"]
    # JAX's expression (gradtts.py:581-591)
    const = -0.5 * np.log(2 * np.pi) * 80
    want = np.asarray(jax.jit(lambda m, yy: (
        -0.5 * jnp.sum(yy ** 2, axis=-1)[:, None, :] + jnp.einsum("bxc,byc->bxy", m, yy)
        - 0.5 * jnp.sum(m ** 2, axis=-1)[:, :, None] + const))(mu_x, y))
    got = port_gt.gaussian_log_prior(torch.as_tensor(np.asarray(mu_x)), torch.as_tensor(y))
    _close("log-prior", got.numpy(), want, atol=0, rtol=1e-5)

    la = np.swapaxes(want, 1, 2)                        # MAS takes [B, T_mel, T_text]
    want_path = np.asarray(jax_mas.maximum_path(la, batch["input_lens"], batch["mel_lens"]))
    got_path = port_mas.maximum_path(torch.as_tensor(la), torch.as_tensor(batch["input_lens"]),
                                     torch.as_tensor(batch["mel_lens"]))
    # the smallest gap between the two predecessors the forward compares
    # (valid cells): a near-tie would show here as a gap of a few ulps
    margin = np.inf
    for b in range(B):
        n_t, n_m = int(batch["input_lens"][b]), int(batch["mel_lens"][b])
        lp = la[b, :n_m, :n_t].astype(np.float64).copy()
        lp[0, 1:] = -np.inf
        for i in range(1, n_m):
            prev, shifted = lp[i - 1], np.concatenate([[-np.inf], lp[i - 1][:-1]])
            both = np.isfinite(prev) & np.isfinite(shifted)
            if both.any():
                margin = min(margin, np.abs(prev[both] - shifted[both]).min())
            lp[i] += np.maximum(prev, shifted)
    print(f"MAS on the log-prior: smallest Viterbi margin {margin:.3e} (log-prior values up to "
          f"{np.abs(want).max():.1f})")
    np.testing.assert_array_equal(got_path.numpy(), want_path)
    assert want_path.sum() == batch["mel_lens"].sum()


@pytest.mark.parametrize("cut", [True, False])
def test_compute_loss_matches_jax(golden_params, cut):
    batch = _inputs() if cut else _inputs(t_mel=16, y_lens=(16, 12))
    key = jax.random.PRNGKey(3)
    model = _jax_model()
    want = jax.jit(lambda p, k: model.apply(
        p, batch["text"], batch["input_lens"], batch["mel"], batch["mel_lens"], k,
        out_size=16, method=jax_gt.GradTTS.compute_loss, rngs={"dropout": k}))(golden_params, key)
    draws = jax_draws(key, B, batch["mel"].shape[1], 16)
    assert ("u" in draws) == cut
    ours = _port(golden_params)
    got = ours.compute_loss(*_t(batch).values(), out_size=16, **draws)
    for name, g, w in zip(("dur_loss", "prior_loss", "diff_loss"), got, want):
        _close(f"compute_loss {name} ({'cut' if cut else 'no cut'})", g.item(), float(w),
               atol=0, rtol=2e-4)


# ---------------------------------------------------------------- trainer

def _batch(seed):
    rng = np.random.default_rng(seed)
    text = rng.integers(1, 40, (B, TT)).astype(np.int32)
    xl = np.asarray([TT, 8], np.int32)
    text[1, 8:] = 0
    yl = np.asarray([TM, 27], np.int32)
    mel = (rng.standard_normal((B, TM, 80)) * (np.arange(TM)[None, :, None] < yl[:, None, None])
           ).astype(np.float32)
    return {"text": text, "input_lens": xl, "mel": mel, "mel_lens": yl}


def _jax_trainer(params, dtype=None):
    model = jax_gt.GradTTS(jax_gt.GradTTSConfig(**SMALL, dtype=dtype))

    def loss_fn(p, batch, rng):  # gradtts/train.py's
        dur, prior, diff = model.apply(
            p, batch["text"], batch["input_lens"], batch["mel"], batch["mel_lens"], rng,
            out_size=16, method=jax_gt.GradTTS.compute_loss, rngs={"dropout": rng})
        return dur + prior + diff, {"dur_loss": dur, "prior_loss": prior, "diff_loss": diff}

    cfg = jax_state.OptimizerConfig(**OPT)
    return jax_harness.Trainer(loss_fn, jax_state.TrainState.create(
        params, jax_state.make_optimizer(cfg)),
        jax_harness.TrainerConfig(optimizer=cfg, seed=SEED, log_every=10 ** 9))


def round_every_bf16_op(trainer, batch):
    """Compile a JAX ``Trainer``'s step with ``xla_allow_excess_precision``
    off, so that XLA rounds each bf16 op's output to bf16 as the program's
    types say (and as the card's bf16 convs and matmuls do), instead of
    keeping f32 between the ops it fuses on the CPU. In the small Grad-TTS
    step this matters at the duration predictor, whose LayerNorm backward
    magnifies the rounding of its input gradient: the port's bf16 weight
    gradient there is 8.4e-3 from JAX's default bf16 step (whose own bf16
    error is 3.3e-3) and 6.0e-4 from this one (whose own is 9.2e-3)."""
    trainer._ensure_mesh(batch)
    mesh = trainer.mesh
    trainer._step = jax.jit(
        trainer._step.__wrapped__,
        in_shardings=(jax_harness.replicated(mesh), jax_harness.data_sharding(mesh),
                      jax_harness.replicated(mesh)),
        donate_argnums=(0,), compiler_options={"xla_allow_excess_precision": False})


def _port_trainer(params, dtype=None):
    return port_harness.Trainer(
        gradtts_train.make_loss_fn(16), _port(params),
        port_harness.TrainerConfig(optimizer=port_state.OptimizerConfig(**OPT), seed=SEED,
                                   log_every=10 ** 9), "cpu", dtype=dtype)


def _port_batch(step, batch):
    key = jax.random.fold_in(jax.random.key(SEED, impl="rbg"), step)
    return {**_t(batch), **jax_draws(key, B, TM, 16)}


@pytest.fixture(scope="module")
def jax_runs(golden_params):
    """JAX's two f32 steps (batches 1, 2) and one bf16 step (batch 1), the
    two trainers compiled in two threads: each step's metrics, parameters
    and (first steps) gradients from Adam's first moment."""

    def run(dtype, n_steps):
        trainer = _jax_trainer(golden_params, dtype)
        if dtype is not None:
            round_every_bf16_op(trainer, _batch(1))
        out = []
        for batch in [_batch(1), _batch(2)][:n_steps]:
            metrics = {k: float(v) for k, v in trainer.train_step(batch).items()}
            grads = (gradtts_from_flax(adam_grads(trainer.state.opt_state, OPT["beta1"]))
                     if not out else None)
            out.append((metrics, gradtts_from_flax(_np(trainer.state.params)), grads))
        return out

    with ThreadPoolExecutor(2) as pool:
        f32, bf16 = pool.submit(run, None, 2), pool.submit(run, jnp.bfloat16, 1)
        return {"f32": f32.result(), "bf16": bf16.result()}


def test_trainer_steps_match_jax_trainer(golden_params, jax_runs):
    ours = _port_trainer(golden_params)
    start = {k: v.clone() for k, v in ours.model.state_dict().items()}
    for step, (batch, (want, jax_sd, _)) in enumerate(zip([_batch(1), _batch(2)],
                                                          jax_runs["f32"])):
        got = ours.train_step(_port_batch(step, batch))
        assert ours.step == step + 1
        assert sorted(got) == sorted(want) == ["diff_loss", "dur_loss", "grad_norm", "loss",
                                               "prior_loss"]
        for k, v in want.items():
            print(f"step {step + 1} {k}: port {float(got[k]):.6e}, JAX {v:.6e}")
            np.testing.assert_allclose(float(got[k]), v, rtol=2e-4, err_msg=f"{step} {k}")
        sd = ours.model.state_dict()
        assert sorted(sd) == sorted(jax_sd)
        worst = max((sd[k] - jax_sd[k]).abs().max().item() for k in sd)
        print(f"step {step + 1} parameters: max |port - JAX| {worst:.3e}")
        for k, v in sd.items():
            np.testing.assert_allclose(v.numpy(), jax_sd[k].numpy(), rtol=3e-3, atol=3e-5,
                                       err_msg=f"step {step + 1} {k}")
    assert max((sd[k] - start[k]).abs().max().item() for k in sd) > 5e-5  # the steps moved


def test_trainer_step_bf16_matches_jax(golden_params, jax_runs):
    (want_b, sd_b, g_b), = jax_runs["bf16"]
    want_f, _, g_f = jax_runs["f32"][0]
    ours = _port_trainer(golden_params, torch.bfloat16)
    got = ours.train_step(_port_batch(0, _batch(1)))
    for k in want_b:
        yardstick(f"Grad-TTS step {k}", float(got[k]), want_b[k], want_f[k])
    names = [n for n, p in ours.model.named_parameters() if p.requires_grad]
    grads_yardstick("Grad-TTS step gradients",
                    {n: (m / (1.0 - OPT["beta1"])).numpy()
                     for n, m in zip(names, ours.optimizer.mu)},
                    {n: g_b[n].numpy() for n in names}, {n: g_f[n].numpy() for n in names})
    sd = ours.model.state_dict()
    assert all(v.dtype == torch.float32 for v in sd.values())
    _param_bound("Grad-TTS step parameters", sd, {k: sd_b[k] for k in sd}, OPT["learning_rate"])


# -------------------------------------------------------------------- CLI

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Four synthetic utterances (0.3-0.6 s) with their texts, and a filelist."""
    from neuraltexttospeech_torch.data.filelist import save_wav

    root = tmp_path_factory.mktemp("gt_corpus")
    rng = np.random.default_rng(0)
    lines = []
    for i, text in enumerate(["Hello there.", "A short one.", "Printing, in the only sense.",
                              "Speech."]):
        n = int(22050 * (0.3 + 0.1 * i))
        t = np.arange(n) / 22050
        path = root / "wavs" / f"utt{i}.wav"
        save_wav(str(path), 0.3 * np.sin(2 * np.pi * (120 + 20 * i) * t)
                 + 0.02 * rng.standard_normal(n), 22050)
        lines.append(f"{path}|{text}")
    (root / "list.txt").write_text("\n".join(lines) + "\n")
    return root


def _train(corpus, out, *extra):
    return gradtts_train.main(["-o", str(out), "-d", str(corpus / "feats"), "--training-files",
                               str(corpus / "list.txt"), "--validation-files",
                               str(corpus / "list.txt"), "--n-enc-layers", "1",
                               "--n-enc-channels", "16", "--dec-dim", "8", "--out-size", "16",
                               "-bs", "2", "--steps-per-epoch", "1", "--device", "cpu", *extra])


def test_prep_batch_matches_jax_cli():
    rng = np.random.default_rng(2)
    batch = {"text": rng.integers(1, 100, (3, 20)).astype(np.int32),
             "input_lens": np.asarray([20, 7, 13], np.int32), "mel": np.zeros((3, 8, 80))}
    got = gradtts_train.prep_batch(batch)
    assert got["text"].shape == (3, 48) and list(got["input_lens"]) == [41, 15, 27]
    for row, n, src, m in zip(got["text"], got["input_lens"], batch["text"],
                              batch["input_lens"]):
        assert list(row[:n:2]) == [148] * (m + 1) and list(row[1:n:2]) == list(src[:m])
        assert not row[n:].any()


def test_cli_train_resume_and_infer(corpus, tmp_path):
    straight = _train(corpus, tmp_path / "a", "--epochs", "2")
    first = _train(corpus, tmp_path / "b", "--epochs", "1")
    resumed = _train(corpus, tmp_path / "b", "--epochs", "2", "--resume")
    assert (straight["steps"], first["steps"], resumed["steps"]) == (2, 1, 1)
    assert resumed["trainer"].step == 2
    assert sorted(resumed["val"]) == ["diff_loss", "dur_loss", "prior_loss"]
    assert all(np.isfinite(v) for v in {**resumed["val"], **resumed["metrics"]}.values())
    a, b = (torch.load(tmp_path / r / "checkpoints" / "2" / "train_state.pt",
                       weights_only=False)["trainer"] for r in ("a", "b"))
    for k, v in a["model"].items():
        torch.testing.assert_close(b["model"][k], v, rtol=0, atol=0)

    lines = tmp_path / "lines.txt"
    lines.write_text("Hello world.\nA second, longer sentence to speak.\n")
    out = tmp_path / "mels"
    gradtts_infer.main(["--checkpoint", str(tmp_path / "b" / "checkpoints" / "2"), "-i",
                        str(lines), "-o", str(out), "--timesteps", "2", "--max-mel-len", "64",
                        "--device", "cpu"])
    for j in range(2):
        mel = np.load(out / f"utt_{j:04d}_mel.npy")
        assert mel.ndim == 2 and mel.shape[1] == 80 and np.isfinite(mel).all()
    model, config = gradtts_infer.load_checkpoint(tmp_path / "b" / "checkpoints" / "2",
                                                  "GradTTS", torch.device("cpu"))
    assert config.n_symbols == 149 and config.n_enc_channels == 16
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, b["model"][k], rtol=0, atol=0)


def test_cli_amp_trains_and_resumes(corpus, tmp_path):
    first = _train(corpus, tmp_path / "c", "--epochs", "1", "--amp")
    resumed = _train(corpus, tmp_path / "c", "--epochs", "2", "--amp", "--resume")
    assert (first["steps"], resumed["steps"], resumed["trainer"].step) == (1, 1, 2)
    assert resumed["trainer"].dtype == torch.bfloat16
    assert all(np.isfinite(v) for v in {**resumed["val"], **resumed["metrics"]}.values())
    state = torch.load(tmp_path / "c" / "checkpoints" / "2" / "train_state.pt",
                       weights_only=False)
    assert all(v.dtype == torch.float32 for v in state["trainer"]["model"].values())


def test_cli_flags_parse_as_jax():
    import importlib

    jax_cli = importlib.import_module("gradtts.train")
    argv = ["-o", "x", "-d", "y", "--training-files", "z", "--amp", "--no-blank"]
    ref, ours = vars(jax_cli.parse_args(argv)), vars(gradtts_train.parse_args(argv))
    assert set(ref) <= set(ours) and ours["amp"] is True and ours["add_blank"] is False
    assert all(ours[k] == v for k, v in ref.items()), {k: (ours[k], v) for k, v in ref.items()
                                                      if ours[k] != v}
