"""FastSpeech 2 in the port against the JAX package, on the CPU.

- the committed ``fastspeech2`` golden (``tools/make_goldens.py:288-331``)
  through ``convert.fastspeech2_from_flax``: mels and log-durations at the
  goldens' 1e-5;
- at ``tests/test_fastspeech2.py::TINY`` (the golden's weights, that file's
  inputs): the teacher-forced forward (every output, 1e-5) and
  ``fastspeech2_loss`` (each term, rtol 1e-5), the dropout-free forward
  against flax's deterministic one;
- the bucket edges equal ``jnp.linspace``'s as the jitted model folds them,
  bit for bit, and the bins equal the jitted ``searchsorted``'s, exact edges
  included;
- inference from predicted variances with JAX's integer durations fed to
  the port (a predicted ``exp(logd) − 1`` near .5 may round the other way;
  the port's own durations are checked wherever they are 1e-3, or in bf16
  two bf16 ulps, from it), f32 at 1e-5 and bf16 by the yardstick of
  ``test_torch_bf16.py``;
- ``kernel_size_2`` of ``PositionwiseConvFF`` against JAX's (9, 1) at 1e-5,
  and the default keeping both kernels equal;
- 1 and 2 ``Trainer`` steps with ``cli/fastspeech2_train.py``'s loss and the
  noam schedule against the JAX ``Trainer``: metrics at rtol 2e-4,
  parameters at rtol 3e-3 / atol 3e-5 (dropout off on both sides: JAX's
  postnet drops at a fixed 0.5, so its step runs deterministic; warm-up 4
  so the steps move, and Adam's eps 1e-6 as in
  ``test_torch_fastpitch_optim.py``: the attention's key bias has a
  gradient that is zero but for rounding); one bf16 step by the yardstick,
  gradients included, against JAX's bf16 step with every bf16 op rounded
  (``test_torch_gradtts_train.round_every_bf16_op``);
- ``parse_textgrid`` and ``FS2Preprocessor`` against JAX's on the synthetic
  TextGrids of ``tests/test_fastspeech2.py:200``: phones, durations and the
  split exactly, log-mels within B1's log-mel budget (``tests/test_audio.py``:
  atol 1e-3, rtol 1e-4), pitch and energy at ``test_torch_fastpitch_data.py``'s
  bounds (energy atol 1e-3, pitch atol 1e-3 of its size), ``stats.json``'s
  statistics at the same bounds;
- ``FS2Dataset`` batches equal JAX's; ``apply_overrides`` equals JAX's;
- prepare → train → ``--resume`` → infer (with a HiFi-GAN checkpoint) at a
  tiny size; ``--amp`` trains; the JAX CLIs' flags parse to the same values.

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
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from neuraltexttospeech_torch.cli import (fastspeech2_infer,  # noqa: E402
                                          fastspeech2_prepare_dataset, fastspeech2_train)
from neuraltexttospeech_torch.convert import fastspeech2_from_flax  # noqa: E402
from neuraltexttospeech_torch.models import fastspeech2 as port_fs2  # noqa: E402
from neuraltexttospeech_torch.train import harness as port_harness  # noqa: E402
from neuraltexttospeech_torch.train import state as port_state  # noqa: E402
from neuraltexttospeech_tpu.models import fastspeech2 as jax_fs2  # noqa: E402
from neuraltexttospeech_tpu.train import harness as jax_harness  # noqa: E402
from neuraltexttospeech_tpu.train import state as jax_state  # noqa: E402
from test_torch_bf16 import _param_bound, adam_grads, grads_yardstick, yardstick  # noqa: E402
from test_torch_gradtts_train import round_every_bf16_op  # noqa: E402
from tools.make_goldens import GOLDEN_DIR  # noqa: E402

# tests/test_fastspeech2.py::TINY (the golden's config)
TINY = dict(n_symbols=40, encoder_layer=1, decoder_layer=1, encoder_hidden=32,
            decoder_hidden=32, conv_filter_size=64, variance_filter_size=16, n_bins=16,
            postnet_dim=24, postnet_layers=2)
NO_DROPOUT = dict(encoder_dropout=0.0, decoder_dropout=0.0, variance_dropout=0.0)
OPT = dict(learning_rate=1e-3, schedule="noam", warmup_steps=4, grad_clip_norm=1.0,
           beta1=0.9, beta2=0.98, eps=1e-6)
B, TT, TM = 2, 8, 24
SEED = 1234


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


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

    return serialization.msgpack_restore((GOLDEN_DIR / "fastspeech2.msgpack").read_bytes())


def _port(params, **cfg):
    model = port_fs2.FastSpeech2(port_fs2.FastSpeech2Config(**TINY, **cfg))
    model.load_state_dict(fastspeech2_from_flax(params))
    model.postnet.p_dropout = 0.0
    return model


def _data(seed):
    """``tests/test_fastspeech2.py::_data``'s draws, as numpy."""
    rng = np.random.default_rng(seed)
    text = rng.integers(1, 40, (B, TT)).astype(np.int32)
    text[1, 5:] = 0
    ilens = np.asarray([TT, 5], np.int32)
    dur = np.zeros((B, TT), np.float32)
    dur[0, :TT] = 3
    dur[1, :5] = 4
    pitch = rng.standard_normal((B, TT)).astype(np.float32)
    energy = rng.standard_normal((B, TT)).astype(np.float32)
    mel = rng.standard_normal((B, TM, 80)).astype(np.float32)
    olens = np.asarray([24, 20], np.int32)
    return {"text": text, "input_lens": ilens, "dur": dur, "pitch": pitch, "energy": energy,
            "mel": mel, "mel_lens": olens}


def _t(batch):
    return {k: torch.as_tensor(np.array(v)) for k, v in batch.items()}


def test_golden_matches(golden_params):
    want = np.load(GOLDEN_DIR / "fastspeech2_golden.npz")
    d = _data(106)  # tools/make_goldens.py:299-311 draws the same way
    out = _port(golden_params)(*_t({k: d[k] for k in ("text", "input_lens")}).values(),
                               mel_max_len=TM, dur_tgt=torch.as_tensor(d["dur"]),
                               pitch_tgt=torch.as_tensor(d["pitch"]),
                               energy_tgt=torch.as_tensor(d["energy"]))
    for k in ("mel_out", "mel_postnet", "log_dur_pred"):
        _close(f"golden {k}", getattr(out, k).detach().numpy(), want[k])


def test_teacher_forced_forward_and_loss_match_jax(golden_params):
    d = _data(0)
    model = jax_fs2.FastSpeech2(jax_fs2.FastSpeech2Config(**TINY))

    @jax.jit
    def run(p):
        out = model.apply(p, d["text"], d["input_lens"], mel_max_len=TM, dur_tgt=d["dur"],
                          pitch_tgt=d["pitch"], energy_tgt=d["energy"])
        return out, jax_fs2.fastspeech2_loss(out, d["mel"], d["dur"], d["pitch"], d["energy"],
                                             d["input_lens"], d["mel_lens"])

    want, (want_total, want_terms) = run(golden_params)
    ours = _port(golden_params)
    b = _t(d)
    got = ours(b["text"], b["input_lens"], mel_max_len=TM, dur_tgt=b["dur"],
               pitch_tgt=b["pitch"], energy_tgt=b["energy"])
    for k in port_fs2.FastSpeech2Output._fields:
        g, w = getattr(got, k), getattr(want, k)
        if k in ("dec_lens", "dec_mask"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=k)
        else:
            _close(f"forward {k}", g.detach().numpy(), w)
    total, terms = port_fs2.fastspeech2_loss(got, b["mel"], b["dur"], b["pitch"], b["energy"],
                                             b["input_lens"], b["mel_lens"])
    assert sorted(terms) == sorted(want_terms)
    for k, v in {"total": want_total, **want_terms}.items():
        _close(f"loss {k}", float(total if k == "total" else terms[k]), float(v), atol=0)


@pytest.mark.parametrize("lo, hi, n", [(-4.0, 4.0, 255), (-1.2345, 3.7, 255), (-2.2, 11.3, 15),
                                       (0.1, 0.7, 100), (-1.7193, 5.9876, 255)])
def test_bucket_edges_bit_for_bit(lo, hi, n):
    want = np.asarray(jax.jit(lambda: jnp.linspace(lo, hi, n))())
    got = port_fs2.bucket_edges(lo, hi, n)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # the bins of values on, beside and between the edges, and past both ends
    rng = np.random.default_rng(n)
    x = np.concatenate([want, np.nextafter(want, np.float32(np.inf)),
                        np.nextafter(want, np.float32(-np.inf)),
                        rng.uniform(lo - 1, hi + 1, 500)]).astype(np.float32)
    # less subnormals (the neighbours of an edge at 0): XLA's CPU flushes
    # them to zero, PyTorch does not
    x = x[(x == 0) | (np.abs(x) >= np.finfo(np.float32).tiny)]
    cfg = jax_fs2.FastSpeech2Config(n_bins=n + 1)
    want_bins = np.asarray(jax.jit(lambda v: jax_fs2.FastSpeech2(cfg)._bucketize(v, lo, hi))(x))
    got_bins = port_fs2.FastSpeech2(port_fs2.FastSpeech2Config(
        n_bins=n + 1, encoder_layer=1, decoder_layer=1))._bucketize(torch.as_tensor(x), lo, hi)
    np.testing.assert_array_equal(got_bins.numpy(), want_bins)


@pytest.mark.parametrize("bf16", [False, True])
def test_inference_with_jax_durations(golden_params, bf16):
    d = _data(1)
    ctl = dict(p_control=1.1, e_control=0.9, d_control=1.0)

    def jax_infer(dtype):
        model = jax_fs2.FastSpeech2(jax_fs2.FastSpeech2Config(**TINY, dtype=dtype))

        @jax.jit
        def run(p):
            out = model.apply(p, d["text"], d["input_lens"], mel_max_len=48, **ctl)
            mask = d["text"] != 0
            dur = jnp.clip(jnp.round(jnp.exp(out.log_dur_pred) - 1.0), 0.0, None)
            return out, dur * ctl["d_control"] * mask.astype(dur.dtype)

        return run(golden_params)

    want, want_dur = jax_infer(jnp.bfloat16 if bf16 else None)
    from neuraltexttospeech_torch.nn.precision import compute_dtype

    ours = _port(golden_params)
    b = _t(d)
    with torch.no_grad(), compute_dtype(torch.bfloat16 if bf16 else None):
        own = ours(b["text"], b["input_lens"], mel_max_len=48, **ctl)
        got = ours(b["text"], b["input_lens"], mel_max_len=48,
                   dur_tgt=torch.as_tensor(np.asarray(want_dur, np.float32)), **ctl)
    # the port's own durations, wherever exp(logd) - 1 is farther from .5
    # than 1e-3 (f32) or two bf16 ulps of its value
    frac = np.exp(np.asarray(want.log_dur_pred, np.float32)) - 1.0
    margin = 2 ** -7 * (1.0 + np.abs(frac)) if bf16 else 1e-3
    clear = np.abs(frac - np.floor(frac) - 0.5) > margin
    own_dur = torch.clamp_min(torch.round(torch.exp(own.log_dur_pred) - 1.0), 0.0).float()
    np.testing.assert_array_equal((own_dur.numpy() * (d["text"] != 0))[clear],
                                  np.asarray(want_dur, np.float32)[clear])
    np.testing.assert_array_equal(got.dec_lens.numpy(), np.asarray(want.dec_lens))
    if not bf16:
        for k in ("mel_out", "mel_postnet", "log_dur_pred", "pitch_pred", "energy_pred"):
            _close(f"inference {k}", getattr(got, k).numpy(), getattr(want, k))
        return
    want_f32, _ = jax_infer(None)
    for k in ("mel_out", "mel_postnet", "log_dur_pred", "pitch_pred", "energy_pred"):
        yardstick(f"FastSpeech 2 inference {k}", getattr(got, k).float().numpy(),
                  getattr(want, k), getattr(want_f32, k))


@pytest.mark.parametrize("k2", [1, None])
def test_kernel_size_2_matches_jax_positionwise_conv_ff(k2):
    from neuraltexttospeech_torch.nn.transformer import PositionwiseConvFF
    from neuraltexttospeech_tpu.nn import transformer as jax_tr

    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 13, 32)).astype(np.float32)
    ff = jax_tr.PositionwiseConvFF(32, 64, kernel_size=9, kernel_size_2=k2)
    params = ff.init(jax.random.PRNGKey(0), x)
    want = ff.apply(params, x)
    ours = PositionwiseConvFF(32, 64, kernel_size=9, kernel_size_2=k2)
    p = params["params"]
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    ours.load_state_dict({
        "conv1.weight": t(np.transpose(p["Conv_0"]["kernel"], (2, 1, 0))),
        "conv1.bias": t(p["Conv_0"]["bias"]),
        "conv2.weight": t(np.transpose(p["Conv_1"]["kernel"], (2, 1, 0))),
        "conv2.bias": t(p["Conv_1"]["bias"]),
        "layer_norm.weight": t(p["LayerNorm_0"]["scale"]),
        "layer_norm.bias": t(p["LayerNorm_0"]["bias"])})
    assert ours.conv2.kernel_size == (k2 or 9,)
    _close(f"PositionwiseConvFF k=(9, {k2})", ours(torch.as_tensor(x)).detach().numpy(), want)


# ---------------------------------------------------------------- trainer

def _batch(seed):
    d = _data(seed)
    return {k: d[k] for k in ("text", "input_lens", "mel", "mel_lens", "dur", "pitch",
                              "energy")}


def _jax_trainer(params, dtype=None):
    model = jax_fs2.FastSpeech2(jax_fs2.FastSpeech2Config(**TINY, **NO_DROPOUT, dtype=dtype))

    def loss_fn(p, batch, rng):  # fastspeech2/train.py's, deterministic
        out = model.apply(p, batch["text"], batch["input_lens"],
                          mel_max_len=batch["mel"].shape[1], dur_tgt=batch["dur"],
                          pitch_tgt=batch["pitch"], energy_tgt=batch["energy"],
                          deterministic=True)
        return jax_fs2.fastspeech2_loss(out, batch["mel"], batch["dur"], batch["pitch"],
                                        batch["energy"], batch["input_lens"], batch["mel_lens"])

    cfg = jax_state.OptimizerConfig(**OPT)
    return jax_harness.Trainer(loss_fn, jax_state.TrainState.create(
        params, jax_state.make_optimizer(cfg)),
        jax_harness.TrainerConfig(optimizer=cfg, seed=SEED, log_every=10 ** 9))


def _port_trainer(params, dtype=None):
    return port_harness.Trainer(
        fastspeech2_train.loss_fn, _port(params, **NO_DROPOUT),
        port_harness.TrainerConfig(optimizer=port_state.OptimizerConfig(**OPT), seed=SEED,
                                   log_every=10 ** 9), "cpu", dtype=dtype)


@pytest.fixture(scope="module")
def jax_runs(golden_params):
    """JAX's two f32 steps (batches 1, 2) and one bf16 step (batch 1), the two
    trainers compiled in two threads."""

    def run(dtype, n_steps):
        trainer = _jax_trainer(golden_params, dtype)
        if dtype is not None:
            round_every_bf16_op(trainer, _batch(1))
        out = []
        for batch in [_batch(1), _batch(2)][:n_steps]:
            metrics = {k: float(v) for k, v in trainer.train_step(batch).items()}
            grads = (fastspeech2_from_flax(adam_grads(trainer.state.opt_state, OPT["beta1"]))
                     if not out else None)
            out.append((metrics, fastspeech2_from_flax(_np(trainer.state.params)), grads))
        return out

    with ThreadPoolExecutor(2) as pool:
        f32, bf16 = pool.submit(run, None, 2), pool.submit(run, jnp.bfloat16, 1)
        return {"f32": f32.result(), "bf16": bf16.result()}


def test_trainer_steps_match_jax_trainer(golden_params, jax_runs):
    ours = _port_trainer(golden_params)
    start = {k: v.clone() for k, v in ours.model.state_dict().items()}
    for step, (batch, (want, jax_sd, _)) in enumerate(zip([_batch(1), _batch(2)],
                                                          jax_runs["f32"])):
        got = ours.train_step(_t(batch))
        assert sorted(got) == sorted(want)
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
    assert max((sd[k] - start[k]).abs().max().item() for k in sd) > 1e-4  # the steps moved


def test_trainer_step_bf16_matches_jax(golden_params, jax_runs):
    (want_b, sd_b, g_b), = jax_runs["bf16"]
    want_f, _, g_f = jax_runs["f32"][0]
    ours = _port_trainer(golden_params, torch.bfloat16)
    got = ours.train_step(_t(_batch(1)))
    for k in want_b:
        yardstick(f"FastSpeech 2 step {k}", float(got[k]), want_b[k], want_f[k])
    names = [n for n, p in ours.model.named_parameters() if p.requires_grad]
    grads_yardstick("FastSpeech 2 step gradients",
                    {n: (m / (1.0 - OPT["beta1"])).numpy()
                     for n, m in zip(names, ours.optimizer.mu)},
                    {n: g_b[n].numpy() for n in names}, {n: g_f[n].numpy() for n in names})
    sd = ours.model.state_dict()
    assert all(v.dtype == torch.float32 for v in sd.values())
    # the first noam step's learning rate
    lr = OPT["learning_rate"] * OPT["warmup_steps"] ** -1.5 * OPT["warmup_steps"] ** 0.5
    _param_bound("FastSpeech 2 step parameters", sd, {k: sd_b[k] for k in sd}, lr)


# ------------------------------------------------------------ preprocessing

GRIDS = {  # tests/test_fastspeech2.py:237-242
    "utt1": [(0.0, 0.2, "sil"), (0.2, 0.45, "HH"), (0.45, 0.451, "AH0"),
             (0.451, 0.8, "AY1"), (0.8, 0.95, "sp")],
    "utt2": [(0.0, 0.31, "DH"), (0.31, 0.5, "spn"), (0.5, 0.77, "IY1")],
    "utt3": [(0.0, 0.6, "sil"), (0.6, 0.7, "sp")],
}


def write_corpus(root, grids, seed=23):
    """The wavs (a 220 Hz tone in noise, as ``tests/test_fastspeech2.py``) and
    TextGrids of ``grids`` under ``root/raw`` and ``root/tg``."""
    from scipy.io import wavfile
    from test_fastspeech2 import _tg

    raw, tgd = root / "raw", root / "tg"
    raw.mkdir(parents=True, exist_ok=True)
    tgd.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for utt, ivs in grids.items():
        xmax = ivs[-1][1]
        (tgd / f"{utt}.TextGrid").write_text(_tg(ivs, xmax))
        t = np.arange(int(22050 * xmax)) / 22050
        w = 0.4 * np.sin(2 * np.pi * 220.0 * t) + 0.01 * rng.standard_normal(len(t))
        wavfile.write(raw / f"{utt}.wav", 22050, (w * 32767).astype(np.int16))
    return raw, tgd


def test_parse_textgrid_matches_jax():
    from test_fastspeech2 import TEXTGRID, _tg

    from neuraltexttospeech_torch.data.textgrid import parse_textgrid as port_parse
    from neuraltexttospeech_tpu.data.textgrid import parse_textgrid as jax_parse

    for text in [TEXTGRID] + [_tg(ivs, ivs[-1][1]) for ivs in GRIDS.values()]:
        assert port_parse(text) == jax_parse(text)


def test_preprocessor_matches_jax(tmp_path):
    from neuraltexttospeech_torch.data.fs2_preprocess import FS2Preprocessor as PortPre
    from neuraltexttospeech_tpu.data.fs2_preprocess import FS2Preprocessor as JaxPre

    raw, tgd = write_corpus(tmp_path, GRIDS)
    pres = {}
    for name, cls, kw in (("port", PortPre, {"device": "cpu"}), ("jax", JaxPre, {})):
        pres[name] = [cls(str(raw), str(tgd), str(tmp_path / f"{name}_{i}"), val_size=1, **kw)
                      for i in range(2)]
    # per utterance, before normalization
    feats = {}
    for utt, ivs in GRIDS.items():
        args = (utt, utt, str(raw / f"{utt}.wav"), str(tgd / f"{utt}.TextGrid"))
        got, want = (pres[n][0].process_utterance(*args) for n in ("port", "jax"))
        assert pres["port"][0].get_alignment(ivs) == pres["jax"][0].get_alignment(ivs)
        if want is None:
            assert got is None and utt == "utt3"  # pure silence is left out
            continue
        assert (got["phones"], got["n_frames"]) == (want["phones"], want["n_frames"])
        for kind in ("duration", "mel"):
            g, w = (np.load(tmp_path / f"{n}_0" / f"{utt}_{kind}.npy") for n in ("port", "jax"))
            assert g.shape == w.shape and g.dtype == w.dtype, (utt, kind)
            if kind == "duration":
                np.testing.assert_array_equal(g, w)
            else:
                _close(f"{utt} log-mel", g, w, atol=1e-3, rtol=1e-4)
        feats[utt] = (got, want)
    bound = {"pitch": 1e-3 * max(np.abs(w["pitch"]).max() for _, w in feats.values()),
             "energy": 1e-3}
    for utt, (got, want) in feats.items():
        for kind in ("pitch", "energy"):
            _close(f"{utt} phone {kind}", got[kind], want[kind], atol=bound[kind], rtol=0)

    # the corpus: the split exactly, the statistics and the normalized features
    got = pres["port"][1].build_from_path([(u, u) for u in GRIDS])
    want = pres["jax"][1].build_from_path([(u, u) for u in GRIDS])
    for split in ("train", "val"):
        assert ((tmp_path / "port_1" / f"{split}.txt").read_text()
                == (tmp_path / "jax_1" / f"{split}.txt").read_text())
    assert sorted(got) == sorted(want) and got["n_frames"] == want["n_frames"]
    for k in ("pitch", "energy"):
        s, std = bound[k], want[f"{k}_std"]
        _close(f"stats {k} mean, std", [got[f"{k}_mean"], got[f"{k}_std"]],
               [want[f"{k}_mean"], want[f"{k}_std"]], atol=s, rtol=0)
        # z = (x - mean) / std with x and mean within s and std within 2 s:
        # z moves by at most 2 s (1 + |z|) / std
        z_max = max(abs(want[f"{k}_min"]), abs(want[f"{k}_max"]))
        z_bound = 2 * s * (1 + z_max) / std
        _close(f"stats {k} min, max", [got[f"{k}_min"], got[f"{k}_max"]],
               [want[f"{k}_min"], want[f"{k}_max"]], atol=z_bound, rtol=0)
        assert got[k] == [got[f"{k}_min"], got[f"{k}_max"], got[f"{k}_mean"], got[f"{k}_std"]]
        for utt in feats:
            g, w = (np.load(tmp_path / f"{n}_1" / f"{utt}_{k}.npy") for n in ("port", "jax"))
            _close(f"{utt} normalized {k}", g, w, atol=z_bound, rtol=0)


def test_fs2_dataset_batches_match_jax(tmp_path):
    jax_cli = importlib.import_module("fastspeech2.train")
    grids = {f"u{i}": [(0.0, 0.1, "sil"), (0.1, 0.3 + 0.05 * i, "HH"),
                       (0.3 + 0.05 * i, 0.6 + 0.05 * i, "AY1")] for i in range(5)}
    raw, tgd = write_corpus(tmp_path, grids)
    from neuraltexttospeech_torch.data.fs2_preprocess import FS2Preprocessor

    FS2Preprocessor(str(raw), str(tgd), str(tmp_path / "feats"), val_size=1,
                    device="cpu").build_from_path([(u, u) for u in grids])
    port = fastspeech2_train.FS2Dataset(str(tmp_path / "feats"))
    ref = jax_cli.FS2Dataset(str(tmp_path / "feats"))
    assert len(port) == len(ref) == 4 and port.frontend == ref.frontend
    for kw in (dict(shuffle=True, seed=3), dict(shuffle=False, drop_last=False)):
        a, b = list(port.batches(3, **kw)), list(ref.batches(3, **kw))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert sorted(x) == sorted(y)
            for k in x:
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    rest = list(port.batches(2, seed=1, skip=1))
    for k, v in list(ref.batches(2, seed=1))[1].items():
        np.testing.assert_array_equal(rest[0][k], v)


def test_apply_overrides_matches_jax():
    from neuraltexttospeech_torch.models.registry import apply_overrides
    from neuraltexttospeech_tpu.models.registry import apply_overrides as jax_apply

    items = ["encoder_layer=2", "conv_kernel_size=[3, 1]", "pitch_min=-2.5", "postnet=false"]
    got = apply_overrides(port_fs2.FastSpeech2Config(), items)
    want = jax_apply(jax_fs2.FastSpeech2Config(), items)
    assert all(getattr(got, f) == getattr(want, f) for f in got.__dataclass_fields__)
    assert got.conv_kernel_size == (3, 1) and got.postnet is False


# -------------------------------------------------------------------- CLIs

TINY_OVERRIDES = [f"{k}={v}" for k, v in dict(
    encoder_layer=1, decoder_layer=1, encoder_hidden=32, decoder_hidden=32, encoder_head=2,
    decoder_head=2, conv_filter_size=64, variance_filter_size=16, n_bins=16, postnet_dim=24,
    postnet_layers=2).items()]
TINY_HG = dict(resblock="2", upsample_rates=[4, 4], upsample_kernel_sizes=[8, 8],
               upsample_initial_channel=32, resblock_kernel_sizes=[3],
               resblock_dilation_sizes=[[1, 2]], n_fft=64, hop_size=16, win_size=64,
               num_mels=80)


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """Five synthetic MFA-aligned utterances through the prep CLI (one held
    out for validation)."""
    root = tmp_path_factory.mktemp("fs2_cli")
    edges = [0.0, 0.1, 0.3, 0.45, 0.7, 0.9, 1.0]
    phones = ["sil", "HH", "AH0", "L", "OW1", "sp"]
    grids = {f"LJ{i:03d}": [(a + 0.04 * i * (a > 0.1), b + 0.04 * i * (b > 0.1), p)
                            for a, b, p in zip(edges[:-1], edges[1:], phones)]
             for i in range(5)}
    raw, tgd = write_corpus(root, grids, seed=4)
    (raw / "metadata.csv").write_text("\n".join(f"{u}|hello|hello" for u in grids) + "\n")
    stats = fastspeech2_prepare_dataset.main(
        ["--raw-path", str(raw), "--textgrid-path", str(tgd), "--out-dir", str(root / "pre"),
         "--val-size", "1", "--device", "cpu"])
    assert stats["pitch_max"] > stats["pitch_min"]
    return root


def _train(prepared, out, *extra):
    return fastspeech2_train.main(
        ["-o", str(out), "-d", str(prepared / "pre"), "--validation-split", "val", "-bs", "2",
         "--steps-per-epoch", "1", "--warmup-steps", "10", "--device", "cpu"]
        + [a for o in TINY_OVERRIDES for a in ("--override", o)] + list(extra))


def test_cli_prepare_train_resume_and_infer(prepared, tmp_path):
    straight = _train(prepared, tmp_path / "a", "--epochs", "2")
    first = _train(prepared, tmp_path / "b", "--epochs", "1")
    resumed = _train(prepared, tmp_path / "b", "--epochs", "2", "--resume")
    assert (straight["steps"], first["steps"], resumed["steps"]) == (2, 1, 1)
    assert resumed["trainer"].step == 2
    assert sorted(resumed["val"]) == ["duration_loss", "energy_loss", "mel_loss", "pitch_loss",
                                      "postnet_loss"]
    assert all(np.isfinite(v) for v in {**resumed["val"], **resumed["metrics"]}.values())
    a, b = (torch.load(tmp_path / r / "checkpoints" / "2" / "train_state.pt",
                       weights_only=False)["trainer"] for r in ("a", "b"))
    for k, v in a["model"].items():
        torch.testing.assert_close(b["model"][k], v, rtol=0, atol=0)
    stats = json.loads((prepared / "pre" / "stats.json").read_text())
    ckpt = tmp_path / "b" / "checkpoints" / "2"
    cfg = json.loads((ckpt / "model_config.json").read_text())
    assert cfg["model"] == "FastSpeech2" and cfg["config"]["encoder_hidden"] == 32
    assert cfg["config"]["pitch_min"] == stats["pitch_min"]
    assert cfg["frontend"]["symbol_set"] == "english_basic"

    from neuraltexttospeech_torch.models.hifigan import Generator, HiFiGANConfig
    from neuraltexttospeech_torch.models.registry import config_from_dict, save_checkpoint

    hg_cfg = config_from_dict(HiFiGANConfig, TINY_HG)
    torch.manual_seed(0)
    hg = save_checkpoint(tmp_path / "hg", "HiFiGAN", hg_cfg, Generator(hg_cfg).state_dict())
    lines = tmp_path / "lines.txt"
    lines.write_text("Hello world.\nAnother line of text to say.\n")
    out = tmp_path / "wavs"
    fastspeech2_infer.main(["--checkpoint", str(ckpt), "-i", str(lines), "-o", str(out),
                            "--hifigan-checkpoint", str(hg), "--max-mel-len", "256",
                            "--duration-control", "1.2", "--device", "cpu"])
    from scipy.io import wavfile

    for j in range(2):
        mel = np.load(out / f"utt_{j:04d}_mel.npy")
        sr, audio = wavfile.read(out / f"utt_{j:04d}.wav")
        assert mel.ndim == 2 and mel.shape[1] == 80 and np.isfinite(mel).all()
        assert sr == 22050 and audio.shape == (mel.shape[0] * 16,)


def test_cli_amp_trains_and_resumes(prepared, tmp_path):
    first = _train(prepared, tmp_path / "c", "--epochs", "1", "--amp")
    resumed = _train(prepared, tmp_path / "c", "--epochs", "2", "--amp", "--resume")
    assert (first["steps"], resumed["steps"], resumed["trainer"].step) == (1, 1, 2)
    assert resumed["trainer"].dtype == torch.bfloat16
    assert all(np.isfinite(v) for v in {**resumed["val"], **resumed["metrics"]}.values())
    state = torch.load(tmp_path / "c" / "checkpoints" / "2" / "train_state.pt",
                       weights_only=False)
    assert all(v.dtype == torch.float32 for v in state["trainer"]["model"].values())


def test_prepare_config_without_yaml_says_so(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(RuntimeError, match="PyYAML"):
        fastspeech2_prepare_dataset.main(["--config", str(tmp_path / "preprocess.yaml"),
                                          "--device", "cpu"])


@pytest.mark.parametrize("cli, argv", [
    ("prepare_dataset", ["--raw-path", "r", "--textgrid-path", "t", "--out-dir", "o"]),
    ("train", ["-o", "x", "-d", "y", "--amp", "--override", "a=1"]),
    ("inference", ["--checkpoint", "c", "-i", "i", "-o", "o", "--amp"]),
])
def test_cli_flags_parse_as_jax(cli, argv):
    jax_cli = importlib.import_module(f"fastspeech2.{cli}")
    ours = {"prepare_dataset": fastspeech2_prepare_dataset, "train": fastspeech2_train,
            "inference": fastspeech2_infer}[cli]
    ref, got = vars(jax_cli.parse_args(argv)), vars(ours.parse_args(argv))
    assert set(ref) <= set(got)
    assert all(got[k] == v for k, v in ref.items()), {k: (got[k], v) for k, v in ref.items()
                                                     if got[k] != v}
