"""TalkNet 2 training and serving in the port against the JAX package, on
the CPU.

- 2 ``Trainer`` steps of each of the four models (``cli/talknet_train.py``'s
  losses and Adam) against 2 steps of ``talknet/train.py``'s jitted step
  (the same losses, ``optax.chain(clip_by_global_norm(1.0), adam(1e-3))``,
  ``mutable=["batch_stats"]``) from the same random weights, at the small
  config of ``tests/test_cli_smoke.py:343-348`` (dropout off: JAX's by
  ``monkeypatch``, the port's ``p_dropout`` at 0): metrics at rtol 2e-4,
  parameters and BatchNorm buffers at rtol 3e-3 / atol 3e-5;
- one ``--amp`` step of each head against JAX's bf16 step compiled with
  XLA's excess precision off (``test_torch_gradtts_train.round_every_bf16_op``'s
  setting), by the yardstick of ``PERF.md`` §2: metrics, gradients (as a
  whole and by the median over parameters) and parameters within 2.5 lr;
- ``cli/talknet_infer.py::synth`` against ``talknet/inference.py``'s
  ``synth`` for the same weights: durations, frame counts and mels;
- the ASR dataset's batches against ``talknet/train.py::_train_asr``'s
  batching (order, padding, labels exactly; log-mels within B1's budget);
- ``config_from_dict`` rebuilds the nested backbone of a JAX-written
  ``model_config.json``; ``apply_overrides`` and the CLIs' flags match JAX's;
- at a tiny size: ASR and head training, ``--resume`` (a straight 2-epoch
  run equals 1 + 1 resumed, BatchNorm buffers included), ``--amp``, and
  ``talknet_infer`` with a HiFi-GAN checkpoint.

``pytest -s`` prints each comparison's largest difference.
"""

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

from neuraltexttospeech_torch.cli import talknet_infer, talknet_train  # noqa: E402
from neuraltexttospeech_torch.convert import quartznet_from_flax, talknet_from_flax  # noqa: E402
from neuraltexttospeech_torch.models import talknet as port_tn  # noqa: E402
from neuraltexttospeech_torch.train import harness as port_harness  # noqa: E402
from neuraltexttospeech_tpu.models import talknet as jax_tn  # noqa: E402
from neuraltexttospeech_tpu.models.gradtts import generate_path as jax_generate_path  # noqa: E402
from neuraltexttospeech_tpu.utils.masking import mask_from_lens as jax_mask  # noqa: E402
from test_torch_bf16 import _param_bound, adam_grads, grads_yardstick, yardstick  # noqa: E402
from test_torch_talknet import BB, HEAD, jax_dropout_off, random_variables  # noqa: E402

KINDS = ("asr", "duration", "pitch", "spectrogram")
HEADS = KINDS[1:]
LR = 1e-3
SEED = 1234
B, TT, TM = 2, 8, 40


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _batch(kind, seed):
    """A random batch of the model's trainer (numpy), padded past its
    lengths."""
    rng = np.random.default_rng(seed)
    if kind == "asr":
        mel_lens = np.asarray([64, 50], np.int32)
        mel = rng.standard_normal((B, 64, 80)).astype(np.float32)
        mel[1, 50:] = 0.0
        labels = rng.integers(1, 29, (B, 16)).astype(np.int32)
        labels[1, 6:] = 0
        return {"mel": mel, "mel_lens": mel_lens, "labels": labels,
                "label_lens": np.asarray([16, 6], np.int32)}
    lens = np.asarray([TT, 5], np.int32)
    text = rng.integers(1, 148, (B, TT)).astype(np.int32)
    text[1, 5:] = 0
    dur = rng.integers(1, 6, (B, TT)).astype(np.float32)
    dur[1, 5:] = 0
    pitch = rng.standard_normal((B, TT)).astype(np.float32)
    pitch[rng.uniform(size=pitch.shape) < 0.25] = 0.0  # unvoiced phones
    pitch[1, 5:] = 0
    mel_lens = dur.sum(1).astype(np.int32)
    mel = rng.standard_normal((B, TM, 80)).astype(np.float32)
    mel[1, mel_lens[1]:] = 0.0
    return {"text": text, "input_lens": lens, "dur": dur, "pitch": pitch, "mel": mel,
            "mel_lens": mel_lens}


def _jax_model(kind, dtype=None):
    bb = jax_tn.QuartzNetConfig(**BB)
    if kind == "asr":
        return jax_tn.QuartzNet(29, bb)
    cfg = jax_tn.TalkNet2Config(**HEAD, backbone=bb, dtype=dtype)
    return {"duration": jax_tn.GraphemeDuration, "pitch": jax_tn.PitchPredictor,
            "spectrogram": jax_tn.SpectrogramModel}[kind](cfg)


def _port_model(kind, dtype=None):
    bb = port_tn.QuartzNetConfig(**BB)
    if kind == "asr":
        return port_tn.QuartzNet(bb)
    return talknet_train.HEADS[kind](port_tn.TalkNet2Config(**HEAD, backbone=bb, dtype=dtype))


def _init_args(kind, b):
    if kind == "asr":
        return (b["mel"],)
    if kind == "duration":
        return b["text"], b["input_lens"]
    return (b["text"], b["dur"]) + ((np.zeros((B, TM), np.float32),) if kind == "spectrogram"
                                     else ()) + (TM,)


def jax_loss_fn(kind, model):
    """``talknet/train.py``'s loss of ``kind`` (:114-121, :200-268), with its
    new batch statistics."""

    def frame_pitch(b):
        m = jnp.ones((b["dur"].shape[0], b["dur"].shape[1], b["mel"].shape[1]))
        return jnp.einsum("bxt,bx->bt", jax_generate_path(b["dur"], m), b["pitch"])

    def loss_fn(variables, b):
        if kind == "asr":
            logp, mut = model.apply(variables, b["mel"], train=True, mutable=["batch_stats"])
            loss = jax_tn.ctc_loss(logp, b["mel_lens"] // 2, b["labels"], b["label_lens"])
            return loss, ({"ctc": loss}, mut["batch_stats"])
        if kind == "duration":
            d, mut = model.apply(variables, b["text"], b["input_lens"], train=True,
                                 mutable=["batch_stats"])
            m = jax_mask(b["input_lens"], b["text"].shape[1]).astype(jnp.float32)
            loss = jnp.sum(jnp.square(d - b["dur"]) * m) / jnp.maximum(jnp.sum(m), 1.0)
            return loss, ({"mse": loss}, mut["batch_stats"])
        if kind == "pitch":
            (f0, voiced), mut = model.apply(variables, b["text"], b["dur"], TM, train=True,
                                            mutable=["batch_stats"])
            tgt = frame_pitch(b)
            m = jax_mask(b["mel_lens"], TM).astype(jnp.float32)
            f0_loss = jnp.sum(jnp.square(f0 - tgt) * m) / jnp.maximum(jnp.sum(m), 1.0)
            v_tgt = (tgt != 0).astype(jnp.float32)
            bce = jnp.mean((jnp.maximum(voiced, 0) - voiced * v_tgt
                            + jnp.log1p(jnp.exp(-jnp.abs(voiced)))) * m)
            return f0_loss + bce, ({"f0_mse": f0_loss, "voiced_bce": bce}, mut["batch_stats"])
        mel, mut = model.apply(variables, b["text"], b["dur"], frame_pitch(b), TM, train=True,
                               mutable=["batch_stats"])
        m = jax_mask(b["mel_lens"], TM)[..., None].astype(jnp.float32)
        loss = jnp.sum(jnp.abs(mel - b["mel"]) * m) / jnp.maximum(jnp.sum(m), 1.0)
        return loss, ({"mel_l1": loss}, mut["batch_stats"])

    return loss_fn


def jax_steps(kind, variables, batches, dtype=None):
    """``talknet/train.py``'s step (:113-127, :279-293) over ``batches``:
    per step (metrics, the new variables, the clipped gradients that Adam
    took, from its first moment)."""
    model = _jax_model(kind, dtype)
    loss_fn = jax_loss_fn(kind, model)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(LR))

    def step(variables, opt_state, batch):
        def wrapped(params):
            return loss_fn({"params": params, "batch_stats": variables["batch_stats"]}, batch)

        (loss, (meta, stats)), grads = jax.value_and_grad(wrapped, has_aux=True)(
            variables["params"])
        updates, opt_state = tx.update(grads, opt_state, variables["params"])
        return ({"params": optax.apply_updates(variables["params"], updates),
                 "batch_stats": stats}, opt_state,
                {"loss": loss, "grad_norm": optax.global_norm(grads), **meta})

    options = {} if dtype is None else {"xla_allow_excess_precision": False}
    step = jax.jit(step, compiler_options=options)
    opt_state, out = tx.init(variables["params"]), []
    for batch in batches:
        variables, opt_state, metrics = step(variables, opt_state, batch)
        out.append(({k: float(v) for k, v in metrics.items()},
                    jax.tree_util.tree_map(np.asarray, variables), adam_grads(opt_state, 0.9)))
    return out


def _convert(kind, variables):
    return (quartznet_from_flax if kind == "asr" else talknet_from_flax)(variables)


@pytest.fixture(scope="module")
def jax_runs():
    """Per model its start weights, JAX's two f32 steps and (heads) one bf16
    step, all compiled at once in threads."""
    start = {kind: random_variables(_jax_model(kind), 40 + i, *_init_args(kind, _batch(kind, 0)))
             for i, kind in enumerate(KINDS)}
    jobs = {}
    with jax_dropout_off(), ThreadPoolExecutor(7) as pool:
        for kind in KINDS:
            jobs[kind, "f32"] = pool.submit(jax_steps, kind, start[kind],
                                            [_batch(kind, 1), _batch(kind, 2)])
            if kind != "asr":
                jobs[kind, "bf16"] = pool.submit(jax_steps, kind, start[kind], [_batch(kind, 1)],
                                                 jnp.bfloat16)
        return {"start": start, **{k: f.result() for k, f in jobs.items()}}


def _port_trainer(kind, start, dtype=None):
    model = _port_model(kind, dtype)
    model.load_state_dict(_convert(kind, start))
    (model if kind == "asr" else model.backbone).p_dropout = 0.0  # JAX's passes through
    return port_harness.Trainer(
        talknet_train.LOSSES[kind], model,
        port_harness.TrainerConfig(optimizer=talknet_train.optimizer_config(LR), seed=SEED,
                                   log_every=10 ** 9), "cpu")


def _t(batch):
    return {k: torch.as_tensor(np.array(v)) for k, v in batch.items()}


@pytest.mark.parametrize("kind", KINDS)
def test_trainer_steps_match_jax(kind, jax_runs):
    ours = _port_trainer(kind, jax_runs["start"][kind])
    first = {k: v.clone() for k, v in ours.model.state_dict().items()}
    for step, (batch, (want, variables, _)) in enumerate(
            zip([_batch(kind, 1), _batch(kind, 2)], jax_runs[kind, "f32"])):
        got = ours.train_step(_t(batch))
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            print(f"{kind} step {step + 1} {k}: port {float(got[k]):.6e}, JAX {v:.6e}")
            np.testing.assert_allclose(float(got[k]), v, rtol=2e-4, err_msg=f"{step} {k}")
        sd, jax_sd = ours.model.state_dict(), _convert(kind, variables)
        assert sorted(sd) == sorted(jax_sd)
        for what, keys in (("parameters", [k for k in sd if "running" not in k]),
                           ("BatchNorm buffers", [k for k in sd if "running" in k])):
            worst = max((sd[k] - jax_sd[k]).abs().max().item() for k in keys)
            print(f"{kind} step {step + 1} {what}: max |port - JAX| {worst:.3e}")
            for k in keys:
                np.testing.assert_allclose(sd[k].numpy(), jax_sd[k].numpy(), rtol=3e-3,
                                           atol=3e-5, err_msg=f"step {step + 1} {k}")
    for part in ("running_mean", "running_var", "weight"):  # the steps moved
        assert max((sd[k] - first[k]).abs().max().item() for k in sd if part in k) > 1e-4


@pytest.mark.parametrize("kind", HEADS)
def test_amp_step_matches_jax_bf16_step(kind, jax_runs):
    (want_b, vars_b, g_b), = jax_runs[kind, "bf16"]
    want_f, _, g_f = jax_runs[kind, "f32"][0]
    start = jax_runs["start"][kind]
    ours = _port_trainer(kind, start, torch.bfloat16)
    got = ours.train_step(_t(_batch(kind, 1)))
    for k in want_b:
        yardstick(f"TalkNet 2 {kind} step {k}", float(got[k]), want_b[k], want_f[k])
    names = [n for n, p in ours.model.named_parameters() if p.requires_grad]
    stats = start["batch_stats"]
    jb, jf = (_convert(kind, {"params": g, "batch_stats": stats}) for g in (g_b, g_f))
    b1 = ours.optimizer.config.beta1
    grads_yardstick(f"TalkNet 2 {kind} step gradients",
                    {n: (m / (1.0 - b1)).numpy() for n, m in zip(names, ours.optimizer.mu)},
                    {n: jb[n].numpy() for n in names}, {n: jf[n].numpy() for n in names})
    sd = ours.model.state_dict()
    assert all(v.dtype == torch.float32 for v in sd.values())
    _param_bound(f"TalkNet 2 {kind} step parameters and buffers", sd, _convert(kind, vars_b),
                 LR)


# ------------------------------------------------------------------ serving

def test_synth_matches_jax_synth(jax_runs):
    """``talknet/inference.py::synth`` (:116-133) and the port's, on the
    start weights of the three heads (the duration head's output bias set
    to 3.3 frames), at ``max_mel_len`` 32."""
    variables = {k: jax.tree_util.tree_map(np.array, jax_runs["start"][k]) for k in HEADS}
    variables["duration"]["params"]["QuartzNet_0"]["Conv_5"]["bias"][:] = 3.3
    models = {k: _jax_model(k) for k in HEADS}
    max_mel_len, max_duration = 32, 128
    rng = np.random.default_rng(7)
    text = rng.integers(1, 148, (3, 16)).astype(np.int32)
    lens = np.asarray([16, 11, 1], np.int32)
    text[np.arange(16)[None] >= lens[:, None]] = 0

    @jax.jit
    def synth(text, text_lens):
        durs = models["duration"].apply(variables["duration"], text, text_lens, train=False)
        durs = jnp.clip(jnp.round(durs.astype(jnp.float32)), 0.0, float(max_duration))
        durs = durs * jax_mask(text_lens, text.shape[1]).astype(durs.dtype)
        f0, voiced = models["pitch"].apply(variables["pitch"], text, durs, max_mel_len,
                                           train=False)
        f0 = jnp.where(jax.nn.sigmoid(voiced) > 0.5, f0.astype(jnp.float32), 0.0)
        mel = models["spectrogram"].apply(variables["spectrogram"], text, durs, f0,
                                          max_mel_len, train=False)
        n = jnp.minimum(jnp.sum(durs, axis=1).astype(jnp.int32), max_mel_len)
        return mel.astype(jnp.float32), n, durs

    want_mel, want_n, want_durs = synth(text, lens)
    heads = []
    for kind in HEADS:
        m = _port_model(kind)
        m.load_state_dict(talknet_from_flax(variables[kind]))
        heads.append(m.eval())
    mel, n, durs = talknet_infer.synth(heads, torch.as_tensor(text), torch.as_tensor(lens),
                                       max_mel_len)
    np.testing.assert_array_equal(durs.numpy(), np.asarray(want_durs))
    np.testing.assert_array_equal(n.numpy(), np.asarray(want_n))
    assert 0 < int(n.min()) < int(n.max()) == max_mel_len  # a row clipped, a row not
    err = np.abs(mel.numpy() - np.asarray(want_mel)).max()
    print(f"synth mel: max |port - JAX| {err:.3e} (max |JAX| {np.abs(want_mel).max():.3e})")
    np.testing.assert_allclose(mel.numpy(), np.asarray(want_mel), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------- data

def _wavs(root, n=4, seed=0):
    """``n`` synthetic wavs (tones in noise, 0.5–0.8 s) and a ``wav|text``
    filelist."""
    from neuraltexttospeech_torch.data.filelist import save_wav

    rng = np.random.default_rng(seed)
    texts = ["hello world", "testing speech", "one two three", "the end", "it's a cat",
             "speech to text"]
    lines = []
    for i in range(n):
        p = root / f"utt{i}.wav"
        t = np.arange(11025 + 1500 * i) / 22050.0
        save_wav(str(p), (0.3 * np.sin(2 * np.pi * (120 + 30 * i) * t)
                          + 0.05 * rng.standard_normal(t.size)).astype(np.float32), 22050)
        lines.append(f"{p}|{texts[i % len(texts)]}")
    fl = root / "asr.txt"
    fl.write_text("\n".join(lines) + "\n")
    return fl


def test_asr_batches_match_jax_batching(tmp_path):
    """``talknet/train.py::_train_asr``'s ``batches`` (:75-94), through the
    JAX package's STFT, against ``data/asr_dataset.py``'s on the CPU."""
    from neuraltexttospeech_torch.data.asr_dataset import ASRDataset
    from neuraltexttospeech_tpu.audio.stft import STFT
    from neuraltexttospeech_tpu.data.filelist import load_filepaths_and_text, load_wav

    fl = _wavs(tmp_path, n=5)
    entries, vocab, stft = load_filepaths_and_text(str(fl)), jax_tn.StringMap(), STFT()
    ds = ASRDataset(str(fl), "cpu")
    for seed, bs in ((3, 2), (4, 5)):
        order = np.arange(len(entries))
        np.random.default_rng(seed).shuffle(order)
        got = list(ds.batches(bs, seed=seed))
        assert len(got) == len(entries) // bs
        for k, b in enumerate(got):
            items = [entries[j] for j in order[k * bs:(k + 1) * bs]]
            mels = [np.asarray(stft.mel_spectrogram(load_wav(w, 22050)[0])) for w, *_ in items]
            labels = [vocab.encode(t[-1]) for t in items]
            T, L = -(-max(len(m) for m in mels) // 64) * 64, -(-max(map(len, labels)) // 16) * 16
            assert b["mel"].shape == (bs, T, 80) and b["labels"].shape == (bs, L)
            np.testing.assert_array_equal(b["mel_lens"], [len(m) for m in mels])
            np.testing.assert_array_equal(b["label_lens"], [len(l) for l in labels])
            assert b["texts"] == [t[-1] for t in items]
            for r, (m, l) in enumerate(zip(mels, labels)):
                np.testing.assert_array_equal(b["labels"][r, :len(l)], l)
                assert not b["labels"][r, len(l):].any() and not b["mel"][r, len(m):].any()
                np.testing.assert_allclose(b["mel"][r, :len(m)].numpy(), m, atol=1e-3, rtol=1e-4)
    rest, whole = list(ds.batches(2, seed=3, skip=1)), list(ds.batches(2, seed=3))
    assert len(rest) == 1 and rest[0]["texts"] == whole[1]["texts"]


def test_nested_config_round_trip_matches_jax(tmp_path):
    from neuraltexttospeech_torch.models import registry as port_reg
    from neuraltexttospeech_tpu.models import registry as jax_reg

    items = ["emb_dim=32", "backbone.module_repeat=1", "backbone.block_params=[[16, 5], [16, 5]]",
             "backbone.final_filters=32", "max_duration=64"]
    want = jax_reg.apply_overrides(jax_tn.TalkNet2Config(dtype=jnp.bfloat16), items)
    got = port_reg.apply_overrides(port_tn.TalkNet2Config(dtype=torch.bfloat16), items)
    assert port_reg.config_to_dict(got) == jax_reg.config_to_dict(want)
    jax_reg.save_model_config(tmp_path, "TalkNet2", want, frontend={"symbol_set": "x"})
    name, loaded = port_reg.load_model_config(tmp_path)
    assert name == "TalkNet2" and loaded == port_tn.TalkNet2Config(
        emb_dim=32, max_duration=64, backbone=port_tn.QuartzNetConfig(
            module_repeat=1, block_params=((16, 5), (16, 5)), final_filters=32))
    assert isinstance(loaded.backbone, port_tn.QuartzNetConfig) and loaded.dtype is None
    port_reg.save_model_config(tmp_path / "p", "QuartzNet", port_tn.QuartzNetConfig(**BB))
    assert jax_reg.load_model_config(tmp_path / "p") == ("QuartzNet", jax_tn.QuartzNetConfig(**BB))
    assert port_reg.MODEL_REGISTRY["QuartzNet"](port_tn.QuartzNetConfig(**BB)).out.out_channels \
        == jax_reg.get_model("QuartzNet", jax_tn.QuartzNetConfig(**BB)).c_output == 29


@pytest.mark.parametrize("cli, argv", [
    ("train", ["--model", "pitch", "-o", "x", "-d", "y", "--amp", "--override", "a=1",
               "--resume"]),
    ("inference", ["--duration-checkpoint", "a", "--pitch-checkpoint", "b",
                   "--spectrogram-checkpoint", "c", "-i", "i", "-o", "o", "--amp"]),
])
def test_cli_flags_parse_as_jax(cli, argv):
    jax_cli = importlib.import_module(f"talknet.{cli}")
    ours = {"train": talknet_train, "inference": talknet_infer}[cli]
    ref, got = vars(jax_cli.parse_args(argv)), vars(ours.parse_args(argv))
    assert set(ref) <= set(got)
    assert all(got[k] == v for k, v in ref.items()), {k: (got[k], v) for k, v in ref.items()
                                                     if got[k] != v}


# -------------------------------------------------------------------- CLIs

ASR_TINY = [f"{k}={json.dumps(v)}" for k, v in BB.items()]
TINY = [f"backbone.{o}" for o in ASR_TINY] + ["emb_dim=32"]
TINY_HG = dict(resblock="2", upsample_rates=[4, 4], upsample_kernel_sizes=[8, 8],
               upsample_initial_channel=32, resblock_kernel_sizes=[3],
               resblock_dilation_sizes=[[1, 2]], n_fft=64, hop_size=16, win_size=64,
               num_mels=80)


def _fs2_corpus(root):
    """A ``fastspeech2_prepare_dataset``-shaped directory: ``train.txt`` and
    each utterance's mel, phone durations (summing to its frames), pitch
    and energy."""
    from neuraltexttospeech_torch.text.processing import TextProcessing

    tp = TextProcessing("english_basic", ["english_cleaners"], p_arpabet=1.0)
    root.mkdir()
    rng = np.random.default_rng(1)
    lines = []
    for i, text in enumerate(["hello world", "testing speech", "one two three", "the end"]):
        n_text = len(tp.encode_text(text))
        dur = rng.integers(1, 5, n_text).astype(np.float32)
        np.save(root / f"utt{i}_mel.npy",
                rng.standard_normal((int(dur.sum()), 80)).astype(np.float32))
        np.save(root / f"utt{i}_duration.npy", dur)
        np.save(root / f"utt{i}_pitch.npy", rng.standard_normal(n_text).astype(np.float32))
        np.save(root / f"utt{i}_energy.npy", rng.standard_normal(n_text).astype(np.float32))
        lines.append(f"utt{i}|{text}")
    (root / "train.txt").write_text("\n".join(lines) + "\n")
    return root


def _train(model, data, out, *extra, tiny=TINY):
    return talknet_train.main(["--model", model, "-o", str(out), "-d", str(data), "-bs", "2",
                               "--steps-per-epoch", "1", "--device", "cpu"]
                              + [a for o in tiny for a in ("--override", o)] + list(extra))


def _trained(out, step):
    return torch.load(out / "checkpoints" / str(step) / "train_state.pt",
                      weights_only=False)["trainer"]["model"]


def test_cli_asr_trains_resumes_and_reports_wer(tmp_path):
    fl = _wavs(tmp_path)
    first = _train("asr", fl, tmp_path / "a", "--epochs", "1", tiny=ASR_TINY)
    resumed = _train("asr", fl, tmp_path / "a", "--epochs", "2", "--resume", tiny=ASR_TINY)
    assert (first["steps"], resumed["steps"], resumed["trainer"].step) == (1, 1, 2)
    assert sorted(resumed["metrics"]) == ["ctc", "grad_norm", "loss", "steps_per_sec", "wer"]
    assert all(np.isfinite(v) for v in resumed["metrics"].values())
    assert 0.0 <= resumed["metrics"]["wer"]
    cfg = json.loads((tmp_path / "a" / "checkpoints" / "2" / "model_config.json").read_text())
    assert cfg["model"] == "QuartzNet" and cfg["config"]["final_filters"] == 32
    assert "dtype" not in cfg["config"]
    assert any("running_var" in k for k in _trained(tmp_path / "a", 2))


def test_cli_heads_train_resume_and_infer(tmp_path):
    data = _fs2_corpus(tmp_path / "pre")
    straight = _train("duration", data, tmp_path / "d2", "--epochs", "2")
    _train("duration", data, tmp_path / "d", "--epochs", "1")
    resumed = _train("duration", data, tmp_path / "d", "--epochs", "2", "--resume")
    assert (straight["steps"], resumed["steps"], resumed["trainer"].step) == (2, 1, 2)
    a, b = _trained(tmp_path / "d2", 2), _trained(tmp_path / "d", 2)
    assert any("running_mean" in k for k in a)
    for k, v in a.items():  # parameters and BatchNorm buffers alike
        torch.testing.assert_close(b[k], v, rtol=0, atol=0, msg=k)
    runs = {"duration": resumed}
    for head, flags in (("pitch", []), ("spectrogram", ["--amp"])):
        runs[head] = _train(head, data, tmp_path / head[0], "--epochs", "1", *flags)
    assert runs["spectrogram"]["config"].dtype == torch.bfloat16
    assert sorted(runs["pitch"]["metrics"]) == ["f0_mse", "grad_norm", "loss", "steps_per_sec",
                                                "voiced_bce"]
    for run in runs.values():
        assert all(np.isfinite(v) for v in run["metrics"].values())
    cfg = json.loads((tmp_path / "s" / "model_config.json").read_text())
    assert cfg["model"] == "TalkNet2" and cfg["config"]["backbone"]["final_filters"] == 32
    assert cfg["frontend"]["symbol_set"] == "english_basic" and "dtype" not in cfg["config"]

    from neuraltexttospeech_torch.models.hifigan import Generator, HiFiGANConfig
    from neuraltexttospeech_torch.models.registry import config_from_dict, save_checkpoint

    # the duration head's output bias at 3 frames a token, so the utterances
    # have a few frames after two steps
    dur_ckpt = talknet_infer.checkpoint_dir(tmp_path / "d")
    sd = torch.load(dur_ckpt / "model.pt", weights_only=True)
    sd["backbone.out.bias"].fill_(3.0)
    torch.save(sd, dur_ckpt / "model.pt")
    hg_cfg = config_from_dict(HiFiGANConfig, TINY_HG)
    torch.manual_seed(0)
    hg = save_checkpoint(tmp_path / "hg", "HiFiGAN", hg_cfg, Generator(hg_cfg).state_dict())
    lines = tmp_path / "lines.txt"
    lines.write_text("Hello world.\nAnother line of text to say.\n")
    from scipy.io import wavfile

    for tag, flags in (("f32", []), ("bf16", ["--amp"])):
        out = tmp_path / f"wavs_{tag}"
        talknet_infer.main(["--duration-checkpoint", str(tmp_path / "d"), "--pitch-checkpoint",
                            str(tmp_path / "p" / "checkpoints"), "--spectrogram-checkpoint",
                            str(talknet_infer.checkpoint_dir(tmp_path / "s")), "-i", str(lines),
                            "-o", str(out), "--hifigan-checkpoint", str(hg), "--max-mel-len",
                            "256", "--device", "cpu"] + flags)
        for j in range(2):
            mel = np.load(out / f"utt_{j:04d}_mel.npy")
            sr, audio = wavfile.read(out / f"utt_{j:04d}.wav")
            assert mel.ndim == 2 and mel.shape[1] == 80 and 0 < mel.shape[0] <= 256
            assert np.isfinite(mel).all()
            assert sr == 22050 and audio.shape == (mel.shape[0] * 16,)
