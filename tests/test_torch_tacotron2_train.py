"""Tacotron 2 training and its CLIs in the port against the JAX package, on
the CPU.

- 2 ``Trainer`` steps (``models/tacotron2_train.py``'s loss and AdamW, at
  eps 1e-5 on both sides: see ``EPS``) against 2 of ``tacotron2_train_step``
  (its state's optimizer) from the same random weights and
  BatchNorm statistics at ``tests/test_tacotron2.py``'s ``TINY`` (dropout
  off: JAX's by ``monkeypatch``, the port's loss given no generator):
  metrics at rtol 2e-4, parameters and BatchNorm buffers at rtol 3e-3 /
  atol 3e-5;
- one ``dtype=bf16`` step against JAX's bf16 step compiled with XLA's excess
  precision off, by the yardstick of ``PERF.md`` §2: metrics, gradients (as
  a whole and by the median over parameters; JAX's from its Adam's first
  moment) and parameters within 2.5 lr;
- the optimizer against ``make_tacotron2_optimizer`` (clip, then AdamW with
  weight decay on every parameter) over three updates at rtol 1e-6;
- ``config_from_dict``/``config_to_dict`` and ``apply_overrides`` against
  the JAX registry's, and the CLIs' flags against the JAX CLIs';
- at a tiny size (``tests/test_cli_smoke.py:267-272``'s overrides):
  ``tacotron2_prepare_dataset`` against JAX's ``prepare_dataset`` (the
  cached log-mels within B1's budget), ``tacotron2_train`` for 2 steps then
  ``--resume`` for a 3rd (equal to a straight 3-step run, BatchNorm
  buffers included), an ``--amp`` step, and ``tacotron2_infer`` with a
  HiFi-GAN checkpoint, f32 and ``--amp``, its mels equal to ``infer`` with
  the prenet's generator seeded 7.

``pytest -s`` prints each comparison's largest difference.
"""

import dataclasses
import importlib
import json
import pathlib
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from neuraltexttospeech_torch.cli import (tacotron2_infer, tacotron2_prepare_dataset,  # noqa: E402
                                          tacotron2_train)
from neuraltexttospeech_torch.convert import tacotron2_from_flax  # noqa: E402
from neuraltexttospeech_torch.models import tacotron2 as port_t2  # noqa: E402
from neuraltexttospeech_torch.models import tacotron2_train as port_t2_train  # noqa: E402
from neuraltexttospeech_torch.train import harness as port_harness  # noqa: E402
from neuraltexttospeech_torch.train.state import Optimizer  # noqa: E402
from neuraltexttospeech_tpu.models import tacotron2 as jax_t2  # noqa: E402
from neuraltexttospeech_tpu.models import tacotron2_train as jax_t2_train  # noqa: E402
from test_tacotron2 import TINY  # noqa: E402
from test_torch_bf16 import _param_bound, adam_grads, grads_yardstick, yardstick  # noqa: E402
from test_torch_tacotron2 import (_t, batch, jax_dropout_off, jax_variables,  # noqa: E402
                                  port_model)
from test_torch_talknet_train import TINY_HG, _wavs  # noqa: E402

LR = 1e-3
SEED = 1234
# The step tests run AdamW at eps 1e-5, not 1e-8: the convs' biases before
# the BatchNorms have gradients that are zero but for rounding (at most 1e-7
# here, against 3e-4 and more elsewhere), and at eps 1e-8 Adam turns that
# rounding into steps of up to lr of either sign. The CLI's optimizer itself
# is held to optax by test_optimizer_matches_optax_chain.
EPS = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def jax_steps(variables, batches, dtype=None):
    """``tacotron2_train_step`` over ``batches``: per step (metrics, the new
    variables, the clipped gradients that AdamW took, from its first
    moment). bf16 compiles with XLA's excess precision off."""
    config = dataclasses.replace(TINY, dtype=dtype)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(LR, eps=EPS, weight_decay=1e-6))
    state = jax_t2_train.Tacotron2TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=tx.init(variables["params"]), tx=tx)
    options = {} if dtype is None else {"xla_allow_excess_precision": False}
    step = jax.jit(jax_t2_train.tacotron2_train_step.__wrapped__, static_argnames=("config",),
                   compiler_options=options)
    out = []
    for b in batches:
        state, meta = step(config, state, b, jax.random.PRNGKey(0))
        out.append(({k: float(v) for k, v in meta.items()},
                    jax.tree_util.tree_map(np.asarray, {"params": state.params,
                                                        "batch_stats": state.batch_stats}),
                    adam_grads(state.opt_state, 0.9)))
    return out


@pytest.fixture(scope="module")
def jax_runs():
    """The start weights, JAX's two f32 steps and one bf16 step, compiled at
    once in threads."""
    start = jax_variables(seed=21)
    with jax_dropout_off(), ThreadPoolExecutor(2) as pool:
        f32 = pool.submit(jax_steps, start, [batch(11), batch(12)])
        bf16 = pool.submit(jax_steps, start, [batch(11)], jnp.bfloat16)
        return {"start": start, "f32": f32.result(), "bf16": bf16.result()}


def port_trainer(variables, dtype=None):
    """A ``Trainer`` over the port model of ``variables``; its loss gets no
    generator (no dropout), as JAX's runs with dropout passed through."""
    return port_harness.Trainer(
        lambda model, b, generator: port_t2_train.loss_fn(model, b, None),
        port_model(variables, dtype),
        port_harness.TrainerConfig(
            optimizer=dataclasses.replace(port_t2_train.optimizer_config(LR), eps=EPS),
            seed=SEED, log_every=10 ** 9), "cpu")


def test_trainer_steps_match_jax(jax_runs):
    ours = port_trainer(jax_runs["start"])
    first = {k: v.clone() for k, v in ours.model.state_dict().items()}
    for step, (b, (want, variables, _)) in enumerate(zip([batch(11), batch(12)],
                                                         jax_runs["f32"])):
        got = ours.train_step(_t(b))
        assert sorted(got) == sorted(list(want) + ["grad_norm"])
        for k, v in want.items():
            print(f"step {step + 1} {k}: port {float(got[k]):.6e}, JAX {v:.6e}")
            np.testing.assert_allclose(float(got[k]), v, rtol=2e-4, err_msg=f"{step} {k}")
        sd, jax_sd = ours.model.state_dict(), tacotron2_from_flax(variables)
        assert sorted(sd) == sorted(jax_sd)
        for what, keys in (("parameters", [k for k in sd if "running" not in k]),
                           ("BatchNorm buffers", [k for k in sd if "running" in k])):
            worst = max((sd[k] - jax_sd[k]).abs().max().item() for k in keys)
            print(f"step {step + 1} {what}: max |port - JAX| {worst:.3e}")
            for k in keys:
                np.testing.assert_allclose(sd[k].numpy(), jax_sd[k].numpy(), rtol=3e-3,
                                           atol=3e-5, err_msg=f"step {step + 1} {k}")
    for part in ("running_mean", "running_var", "weight_hh", "embedding"):  # the steps moved
        assert max((sd[k] - first[k]).abs().max().item() for k in sd if part in k) > 1e-4


def test_amp_step_matches_jax_bf16_step(jax_runs):
    (want_b, vars_b, g_b), = jax_runs["bf16"]
    want_f, _, g_f = jax_runs["f32"][0]
    start = jax_runs["start"]
    ours = port_trainer(start, torch.bfloat16)
    got = ours.train_step(_t(batch(11)))
    for k in want_b:
        yardstick(f"Tacotron 2 step {k}", float(got[k]), want_b[k], want_f[k])
    names = [n for n, p in ours.model.named_parameters() if p.requires_grad]
    jb, jf = (tacotron2_from_flax({"params": g, "batch_stats": start["batch_stats"]})
              for g in (g_b, g_f))
    b1 = ours.optimizer.config.beta1
    grads_yardstick("Tacotron 2 step gradients",
                    {n: (m / (1.0 - b1)).numpy() for n, m in zip(names, ours.optimizer.mu)},
                    {n: jb[n].numpy() for n in names}, {n: jf[n].numpy() for n in names})
    sd = ours.model.state_dict()
    assert all(v.dtype == torch.float32 for v in sd.values())
    _param_bound("Tacotron 2 step parameters and buffers", sd, tacotron2_from_flax(vars_b), LR)


def test_optimizer_matches_optax_chain():
    """``clip_by_global_norm(1.0)`` then ``adamw(lr, weight_decay=1e-6)`` on
    every parameter, three updates (the second one clipped)."""
    rng = np.random.default_rng(4)
    params = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,), (2, 2))]
    grads = [[(rng.standard_normal(p.shape) * scale).astype(np.float32) for p in params]
             for scale in (0.1, 3.0, 0.2)]
    tx = jax_t2_train.make_tacotron2_optimizer(LR)
    jp, state = list(params), tx.init(list(params))
    ours = [torch.nn.Parameter(torch.as_tensor(p.copy())) for p in params]
    opt = Optimizer(ours, port_t2_train.optimizer_config(LR))
    for g in grads:
        updates, state = tx.update(list(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step([torch.as_tensor(x.copy()) for x in g])
    for got, want in zip(ours, jp):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-9)


def test_config_round_trip_and_overrides_match_jax(tmp_path):
    from neuraltexttospeech_torch.models import registry as port_reg
    from neuraltexttospeech_tpu.models import registry as jax_reg

    items = ["decoder_rnn_dim=64", "attention_location_kernel_size=7", "gate_threshold=0.4",
             "mask_padding=false", "scan_unroll=2"]
    want = jax_reg.apply_overrides(jax_t2.Tacotron2Config(dtype=jnp.bfloat16), items)
    got = port_reg.apply_overrides(port_t2.Tacotron2Config(dtype=torch.bfloat16), items)
    assert port_reg.config_to_dict(got) == jax_reg.config_to_dict(want)
    assert got.dtype == torch.bfloat16 and not got.mask_padding
    jax_reg.save_model_config(tmp_path, "Tacotron2", want)
    name, loaded = port_reg.load_model_config(tmp_path)
    assert name == "Tacotron2" and loaded == dataclasses.replace(got, dtype=None)
    port_reg.save_model_config(tmp_path / "p", "Tacotron2", got)
    assert jax_reg.load_model_config(tmp_path / "p") == ("Tacotron2",
                                                         dataclasses.replace(want, dtype=None))
    assert isinstance(port_reg.MODEL_REGISTRY["Tacotron2"](loaded), port_t2.Tacotron2)


@pytest.mark.parametrize("cli, argv", [
    ("train", ["-o", "x", "-d", "y", "--training-files", "z", "--amp", "--override", "a=1",
               "--resume", "--validation-files", "v", "-bs", "4", "--n-symbols", "40"]),
    ("inference", ["--checkpoint", "c", "-i", "i", "-o", "o", "--amp", "-bs", "2",
                   "--max-decoder-steps", "16", "--hifigan-checkpoint", "h"]),
])
def test_cli_flags_parse_as_jax(cli, argv):
    jax_cli = importlib.import_module(f"tacotron2.{cli}")
    ours = {"train": tacotron2_train, "inference": tacotron2_infer}[cli]
    ref, got = vars(jax_cli.parse_args(argv)), vars(ours.parse_args(argv))
    assert set(ref) <= set(got)
    assert all(got[k] == v for k, v in ref.items()), {k: (got[k], v) for k, v in ref.items()
                                                     if got[k] != v}


# -------------------------------------------------------------------- CLIs

TINY_OVERRIDES = ["symbols_embedding_dim=32", "encoder_embedding_dim=32",
                  "encoder_n_convolutions=1", "attention_rnn_dim=32", "decoder_rnn_dim=32",
                  "attention_dim=16", "prenet_dim=16", "attention_location_n_filters=4",
                  "attention_location_kernel_size=7", "postnet_embedding_dim=32",
                  "postnet_n_convolutions=2"]


def _train(data, filelist, out, *extra):
    return tacotron2_train.main(["-o", str(out), "-d", str(data), "--training-files",
                                 str(filelist), "-bs", "2", "--steps-per-epoch", "1",
                                 "--device", "cpu"]
                                + [a for o in TINY_OVERRIDES for a in ("--override", o)]
                                + list(extra))


def _trained(out, step):
    return torch.load(out / "checkpoints" / str(step) / "train_state.pt",
                      weights_only=False)["trainer"]["model"]


def test_cli_prepare_train_resume_and_infer(tmp_path):
    fl = _wavs(tmp_path, n=4)
    feats = tmp_path / "feats"
    ds = tacotron2_prepare_dataset.main(["-d", str(feats), "--training-files", str(fl),
                                         "--device", "cpu"])
    assert len(ds) == 4
    from tacotron2.prepare_dataset import main as jax_prepare

    jax_prepare(["-d", str(tmp_path / "jax_feats"), "--training-files", str(fl)])
    for i in range(4):
        got, want = (np.load(d / f"utt{i}_mel.npy") for d in (feats, tmp_path / "jax_feats"))
        assert got.shape == want.shape and got.shape[1] == 80
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-4)

    straight = _train(feats, fl, tmp_path / "s", "--epochs", "3")
    _train(feats, fl, tmp_path / "r", "--epochs", "2")
    resumed = _train(feats, fl, tmp_path / "r", "--epochs", "3", "--resume")
    assert (straight["steps"], resumed["steps"], resumed["trainer"].step) == (3, 1, 3)
    assert sorted(resumed["metrics"]) == ["gate_loss", "grad_norm", "loss", "mel_loss",
                                          "steps_per_sec"]
    assert all(np.isfinite(v) for v in resumed["metrics"].values())
    a, b = _trained(tmp_path / "s", 3), _trained(tmp_path / "r", 3)
    assert any("running_mean" in k for k in a)
    for k, v in a.items():  # parameters and BatchNorm buffers alike
        torch.testing.assert_close(b[k], v, rtol=0, atol=0, msg=k)
    amp = _train(feats, fl, tmp_path / "amp", "--epochs", "1", "--amp")
    assert amp["config"].dtype == torch.bfloat16 and amp["steps"] == 1
    assert all(np.isfinite(v) for v in amp["metrics"].values())
    cfg = json.loads((tmp_path / "r" / "checkpoints" / "3" / "model_config.json").read_text())
    assert cfg["model"] == "Tacotron2" and cfg["config"]["decoder_rnn_dim"] == 32
    assert "dtype" not in cfg["config"]

    from neuraltexttospeech_torch.models.hifigan import Generator, HiFiGANConfig
    from neuraltexttospeech_torch.models.registry import config_from_dict, save_checkpoint
    from neuraltexttospeech_torch.text.processing import TextProcessing
    from neuraltexttospeech_torch.utils.serving import text_batches
    from scipy.io import wavfile

    hg_cfg = config_from_dict(HiFiGANConfig, TINY_HG)
    torch.manual_seed(0)
    hg = save_checkpoint(tmp_path / "hg", "HiFiGAN", hg_cfg, Generator(hg_cfg).state_dict())
    texts = ["Hello world.", "Another line of text to say."]
    lines = tmp_path / "lines.txt"
    lines.write_text("\n".join(texts) + "\n")
    model = tacotron2_infer.load_tacotron2(tmp_path / "r", torch.device("cpu"), 16)
    tp = TextProcessing("english_basic", ["english_cleaners"], p_arpabet=0.0)
    encoded = [np.asarray(tp.encode_text(t), np.int32) for t in texts]
    (idxs, text, lens), = text_batches(encoded, 2)
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        want = model.infer(torch.as_tensor(text), torch.as_tensor(lens), generator=gen)
    for tag, flags in (("f32", []), ("bf16", ["--amp"])):
        out = tmp_path / f"wavs_{tag}"
        tacotron2_infer.main(["--checkpoint", str(tmp_path / "r" / "checkpoints"), "-i",
                              str(lines), "-o", str(out), "--hifigan-checkpoint", str(hg),
                              "--max-decoder-steps", "16", "--device", "cpu"] + flags)
        for r, j in enumerate(idxs):
            mel = np.load(out / f"utt_{j:04d}_mel.npy")
            sr, audio = wavfile.read(out / f"utt_{j:04d}.wav")
            assert mel.shape[1] == 80 and 0 < mel.shape[0] <= 16 and np.isfinite(mel).all()
            assert sr == 22050 and audio.shape == (mel.shape[0] * 16,)
            if tag == "f32":  # the CLI's decode is infer's with the prenet seeded 7
                n = int(want.mel_lengths[r])
                np.testing.assert_allclose(mel, want.mel_out_postnet[r, :n].numpy(), rtol=1e-5,
                                           atol=1e-6)
