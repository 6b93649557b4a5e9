"""The port's data tools against the JAX package, on the CPU.

Four synthetic wavs with their features cached by the port's
``FastPitchDataset`` (the JAX dataset reads the same files), a small
FastPitch (the ``fastpitch`` golden's widths, the ``english_basic`` symbol
set) and a small Tacotron 2 (``tests/test_tacotron2.py``'s ``TINY``, the same
symbol set), each with random weights drawn with numpy and written as a port
checkpoint:

- ``dump_mels --model fastpitch``: each dumped mel equal to JAX's training
  forward's ``mel_out`` on the same weights and batches (atol 1e-4), trimmed
  to its mel length;
- ``dump_mels --model tacotron2``: the postnet mels of the teacher-forced
  eval forward with the prenet's dropout drawn from a generator seeded 7,
  against JAX's forward given the same masks (atol 1e-4); JAX's own tool
  path raises (flax refuses the prenet's dropout without a stream, and the
  tool reads an output field that does not exist);
- ``align_from_fastpitch``: the durations exactly JAX's ``attn_hard_dur``,
  each summing to its mel's frames; pitch and energy within 1e-5 of JAX's
  ``pitch_tgt[:, 0]`` and ``energy_tgt``; the mels, ``train.txt`` and
  ``frontend.json``;
- ``export``: the newest step, reloaded from the artifact, gives the same
  outputs as the checkpoint it came from;
- the tools' flags against the JAX tools'.

``pytest -s`` prints each comparison's largest difference.
"""

import contextlib
import dataclasses
import importlib
import json
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

from neuraltexttospeech_torch.cli import align_from_fastpitch, dump_mels, export  # noqa: E402
from neuraltexttospeech_torch.convert import (fastpitch_train_from_flax,  # noqa: E402
                                              tacotron2_from_flax)
from neuraltexttospeech_torch.data.dataset import FastPitchDataset  # noqa: E402
from neuraltexttospeech_torch.models import fastpitch as port_fp  # noqa: E402
from neuraltexttospeech_torch.models import tacotron2 as port_t2  # noqa: E402
from neuraltexttospeech_torch.models.registry import load_checkpoint, save_checkpoint  # noqa: E402
from neuraltexttospeech_tpu.models import fastpitch as jax_fp  # noqa: E402
from neuraltexttospeech_tpu.models import tacotron2 as jax_t2  # noqa: E402
from test_tacotron2 import TINY as T2_TINY  # noqa: E402
from test_torch_talknet import _close, random_variables  # noqa: E402
from test_torch_talknet_train import _wavs  # noqa: E402

# the fastpitch golden's widths (tools/make_goldens.py:62-69), english_basic's symbols
FP_SMALL = dict(n_symbols=148, symbols_embedding_dim=64, in_fft_n_layers=1, in_fft_d_head=16,
                in_fft_n_heads=2, in_fft_conv1d_filter_size=128, out_fft_n_layers=1,
                out_fft_d_head=16, out_fft_n_heads=2, out_fft_conv1d_filter_size=128,
                dur_predictor_filter_size=32, pitch_predictor_filter_size=32,
                energy_predictor_filter_size=32)
T2_SMALL = dataclasses.replace(T2_TINY, n_symbols=148)
FRONTEND = {"text_cleaners": ["english_cleaners_v2"], "symbol_set": "english_basic",
            "p_arpabet": 1.0}
BATCH = 2


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def jax_batches(root, **kw):
    """The JAX dataset over the cached features, batched as the JAX tools
    batch (file order, ``collate``'s padding)."""
    from neuraltexttospeech_tpu.data.dataset import FastPitchDataset as JaxDataset

    ds = JaxDataset(str(root / "feats"), str(root / "list.txt"), **kw)
    for start in range(0, len(ds), BATCH):
        items = [ds[i] for i in range(start, min(start + BATCH, len(ds)))]
        yield items, JaxDataset.collate(items)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The wavs, their cached features (log-mel, pitch, prior), a FastPitch
    checkpoint with the aligner and JAX's training forward over the
    batches: ``(root, {stem: (mel_out, durations, pitch, energy)})``."""
    root = tmp_path_factory.mktemp("tools")
    fl = _wavs(root, n=4)
    fl.rename(root / "list.txt")
    FastPitchDataset(str(root / "feats"), str(root / "list.txt"), device="cpu").prepare()
    config = jax_fp.FastPitchConfig(**FP_SMALL)
    model = jax_fp.FastPitch(config)
    b0 = next(jax_batches(root))[1]
    variables = random_variables(model, 3, b0["text"], b0["input_lens"], b0["mel"],
                                 b0["mel_lens"], b0["pitch"], b0["energy"], None,
                                 b0["attn_prior"])
    save_checkpoint(root / "fp" / "checkpoints" / "5", "FastPitch",
                    port_fp.FastPitchConfig(**FP_SMALL), fastpitch_train_from_flax(variables),
                    frontend=FRONTEND)
    forward = jax.jit(lambda v, b: model.apply(
        v, b["text"], b["input_lens"], b["mel"], b["mel_lens"], b["pitch"], b["energy"], None,
        b["attn_prior"]))
    want = {}
    for items, b in jax_batches(root):
        o = forward(variables, {k: v for k, v in b.items() if isinstance(v, np.ndarray)})
        for j, it in enumerate(items):
            n_text, n_mel = len(it["text"]), it["mel"].shape[0]
            stem = pathlib.Path(it["audiopath"]).stem
            want[stem] = (np.asarray(o.mel_out[j, :n_mel]), np.asarray(o.attn_hard_dur[j, :n_text]),
                          np.asarray(o.pitch_tgt[j, 0, :n_text]),
                          np.asarray(o.energy_tgt[j, :n_text]))
    return root, want


def _argv(root, *extra):
    return ["-d", str(root / "feats"), "--training-files", str(root / "list.txt"),
            "--batch-size", str(BATCH), "--device", "cpu"] + list(extra)


def test_dump_mels_fastpitch_matches_jax_forward(corpus):
    root, want = corpus
    out = root / "fp_mels"
    assert dump_mels.main(_argv(root, "--model", "fastpitch", "--checkpoint", str(root / "fp"),
                                "-o", str(out))) == len(want)
    for stem, (mel, *_) in want.items():
        got = np.load(out / f"{stem}_mel.npy")
        assert got.shape == np.load(root / "feats" / f"{stem}_mel.npy").shape
        _close(f"dumped FastPitch mel {stem}", got, mel, atol=1e-4, rtol=1e-4)


def test_align_from_fastpitch_matches_jax(corpus):
    root, want = corpus
    out = root / "aligned"
    lines = align_from_fastpitch.main(_argv(root, "--checkpoint",
                                            str(root / "fp" / "checkpoints"), "-o", str(out)))
    assert json.loads((out / "frontend.json").read_text()) == FRONTEND
    texts = [line.split("|")[1] for line in (root / "list.txt").read_text().splitlines()]
    assert lines == [f"utt{i}|{t}" for i, t in enumerate(texts)]
    assert (out / "train.txt").read_text() == "\n".join(lines) + "\n"
    for stem, (_, durs, pitch, energy) in want.items():
        got = {k: np.load(out / f"{stem}_{k}.npy") for k in ("mel", "duration", "pitch",
                                                              "energy")}
        np.testing.assert_array_equal(got["mel"], np.load(root / "feats" / f"{stem}_mel.npy"))
        np.testing.assert_array_equal(got["duration"], durs)
        assert got["duration"].sum() == got["mel"].shape[0]
        _close(f"aligned pitch {stem}", got["pitch"], pitch, atol=1e-5, rtol=0)
        _close(f"aligned energy {stem}", got["energy"], energy, atol=1e-5, rtol=0)
    print("durations: " + "; ".join(f"{s} {np.load(out / f'{s}_duration.npy').astype(int).tolist()}"
                                    for s in want))


@contextlib.contextmanager
def jax_dropout_masks(masks):
    """JAX's ``tacotron2`` module with an ``nn`` whose ``Dropout``, where it
    is not deterministic, applies the next of ``masks`` (the prenet's two,
    in call order) as the port's ``nn/layers.py::dropout`` does."""
    masks = list(masks)

    def dropout(rate, deterministic=None):
        def apply(x, deterministic=deterministic):
            if deterministic:
                return x
            return jnp.where(masks.pop(0), x / (1.0 - rate), 0.0)
        return apply

    view = types.SimpleNamespace(**{k: getattr(flax_nn, k) for k in dir(flax_nn)
                                    if not k.startswith("__")})
    view.Dropout = dropout
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_t2, "nn", view)
        yield masks


def test_dump_mels_tacotron2_matches_jax_forward(corpus):
    root, _ = corpus
    model = jax_t2.Tacotron2(T2_SMALL)
    items, b = next(jax_batches(root, with_pitch=False, with_prior=False))
    args = (b["text"], b["input_lens"], b["mel"], b["mel_lens"])
    variables = random_variables(model, 5, *args)
    port_cfg = port_t2.Tacotron2Config(**{f.name: getattr(T2_SMALL, f.name)
                                          for f in dataclasses.fields(T2_SMALL)
                                          if f.name != "dtype"})
    save_checkpoint(root / "t2", "Tacotron2", port_cfg, tacotron2_from_flax(variables))
    # tools/dump_mels.py:92-96 as it stands: flax refuses the prenet's dropout
    # without a stream, and the output has no ``mel_post`` (it is ``mel_out_postnet``)
    with pytest.raises(Exception, match="PRNG"):
        jax.jit(lambda v: model.apply(v, *args).mel_out_postnet)(variables)
    assert "mel_post" not in jax_t2.Tacotron2Output._fields

    out = root / "t2_mels"
    dump_mels.main(_argv(root, "--model", "tacotron2", "--checkpoint", str(root / "t2"),
                         "-o", str(out)))
    for items, b in jax_batches(root, with_pitch=False, with_prior=False):
        gen = torch.Generator().manual_seed(7)
        shape = b["mel"].shape[:2] + (T2_SMALL.prenet_dim,)
        masks = [(torch.rand(shape, generator=gen) < 0.5).numpy() for _ in range(2)]
        with jax_dropout_masks(masks) as left:
            want = np.asarray(model.apply(variables, b["text"], b["input_lens"], b["mel"],
                                          b["mel_lens"]).mel_out_postnet)
        assert not left
        for j, it in enumerate(items):
            stem = pathlib.Path(it["audiopath"]).stem
            _close(f"dumped Tacotron 2 mel {stem}", np.load(out / f"{stem}_mel.npy"),
                   want[j, :it["mel"].shape[0]], atol=1e-4, rtol=1e-4)


def test_export_round_trips(corpus, tmp_path):
    root, _ = corpus
    cfg = port_fp.FastPitchConfig(**FP_SMALL)
    run = tmp_path / "run"
    for step, seed in ((3, 0), (12, 1)):
        torch.manual_seed(seed)
        save_checkpoint(run / "checkpoints" / str(step), "FastPitch", cfg,
                        port_fp.FastPitch(cfg).state_dict())
    art = tmp_path / "out" / "fastpitch.pt"
    meta = export.main(["--model", "FastPitch", "--checkpoint", str(run), "-o", str(art)])
    assert meta == json.loads(art.with_suffix(".json").read_text())
    assert (meta["model"], meta["step"], meta["config"]["symbols_embedding_dim"]) == (
        "FastPitch", 12, 64)
    model, _ = export.load_export(art)
    want, _ = load_checkpoint(run / "checkpoints" / "12", "FastPitch", torch.device("cpu"))
    text = torch.randint(1, 148, (2, 16), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        for got, ref in zip(model.infer(text, None, max_mel_len=64),
                            want.infer(text, None, max_mel_len=64)):
            torch.testing.assert_close(got, ref, rtol=0, atol=0)
    with pytest.raises(SystemExit, match="holds a FastPitch"):
        export.main(["--model", "Flowtron", "--checkpoint", str(run), "-o", str(art)])


@pytest.mark.parametrize("tool, argv", [
    ("dump_mels", ["--model", "tacotron2", "--checkpoint", "c", "-d", "d", "--training-files",
                   "t", "-o", "o", "--batch-size", "3", "--n-speakers", "2"]),
    ("align_from_fastpitch", ["--checkpoint", "c", "-d", "d", "--training-files", "t", "-o",
                              "o", "--split", "val", "--batch-size", "3", "--text-cleaners",
                              "basic_cleaners", "--symbol-set", "english_basic",
                              "--p-arpabet", "0.5"]),
])
def test_tool_flags_parse_as_jax(tool, argv):
    jax_tool = importlib.import_module(f"tools.{tool}")
    ours = {"dump_mels": dump_mels, "align_from_fastpitch": align_from_fastpitch}[tool]
    ref, got = vars(jax_tool.parse_args(argv)), vars(ours.parse_args(argv))
    assert set(ref) <= set(got)
    assert all(got[k] == v for k, v in ref.items()), {k: (got[k], v) for k, v in ref.items()
                                                     if got[k] != v}
