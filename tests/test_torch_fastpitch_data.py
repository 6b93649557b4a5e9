"""FastPitch dataset preparation and the two training CLIs, on the CPU.

- ``data/pitch.py``: yin and pyin against JAX's on a tone, on noise and on a
  tone under noise with silence: voicing equal frame by frame, f0 at rtol
  1e-3 on voiced frames (two f32 FFT and cumsum implementations);
- ``data/dataset.py``: items, batch order and collation against the JAX
  dataset on synthetic wavs: text, lengths, priors and padding exactly, the
  log-mels to 1e-4 (the rFFT log-mel budget of ``tests/test_torch_audio.py``),
  energies to 1e-3 and pitch as above;
- ``cli/fastpitch_prepare_dataset.py`` then ``cli/fastpitch_train.py`` at a
  tiny size: 2 steps straight equal 1 step, ``--resume``, 1 step, bit for bit
  (the same ops on the CPU); ``cli/fastpitch_infer.py`` loads the trained
  checkpoint, and its model is the trainer's;
- ``--amp`` (bf16) trains 1 step, ``--resume`` 1 step, into f32
  checkpoints that the serving CLI reads in bf16; every flag of the JAX CLI
  is taken, and without ``--device`` the CLIs raise when there is no card.
"""

import numpy as np
import pytest
import torch

from neuraltexttospeech_torch.data import pitch as port_pitch
from neuraltexttospeech_tpu.data import pitch as jax_pitch

SR = 22050
TEXTS = ["The quick brown fox jumps over the lazy dog.", "Hello world.",
         "She sells sea shells by the sea shore.", "How much wood would a woodchuck chuck?",
         "Speech synthesis turns written text into audible speech."]
# a small FastPitch through the JAX CLI's model flags
TINY_FLAGS = ["--symbols-embedding-dim", "32", "--in-fft-n-layers", "1",
              "--out-fft-n-layers", "1"]


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


def _signal(kind, seconds=0.8):
    rng = np.random.default_rng(1)
    t = np.arange(int(SR * seconds)) / SR
    tone = np.sin(2 * np.pi * 180.0 * t) + 0.4 * np.sin(2 * np.pi * 360.0 * t)
    noise = rng.standard_normal(t.size)
    if kind == "tone":
        x = 0.5 * tone
    elif kind == "noise":
        x = 0.1 * noise
    else:  # a tone under noise, then silence
        x = np.concatenate([0.3 * tone + 0.05 * noise, np.zeros(SR // 5)])
    return x.astype(np.float32)


@pytest.mark.parametrize("method", ["yin_pitch", "pyin_pitch"])
@pytest.mark.parametrize("kind", ["tone", "noise", "noisy_tone"])
def test_pitch_matches_jax(kind, method):
    x = _signal(kind)
    want = np.asarray(getattr(jax_pitch, method)(x, sr=SR))
    got = getattr(port_pitch, method)(x, sr=SR).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got > 0, want > 0)
    voiced = want > 0
    _report(f"{method} {kind} f0 on {int(voiced.sum())} voiced frames", got[voiced],
            want[voiced], rel=True)
    if kind != "noise":
        assert voiced.mean() > 0.5
    np.testing.assert_allclose(got[voiced], want[voiced], rtol=1e-3)


def test_estimate_pitch_matches_jax():
    x = _signal("noisy_tone")
    kw = dict(sr=SR, normalize_mean=214.72203, normalize_std=65.72038)
    want = jax_pitch.estimate_pitch(x, 90, **kw)
    got = port_pitch.estimate_pitch(x, 90, **kw)
    assert got.shape == want.shape == (1, 90) and got.dtype == np.float32
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Five synthetic utterances of 0.5-1.3 s and their filelist."""
    from neuraltexttospeech_torch.data.filelist import save_wav

    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    lines = []
    for i, text in enumerate(TEXTS):
        n = int(SR * (0.5 + 0.2 * ((i * 3) % 5)))
        t = np.arange(n) / SR
        w = 0.3 * np.sin(2 * np.pi * (110 + 30 * i) * t) + 0.02 * rng.standard_normal(n)
        path = root / "wavs" / f"utt{i}.wav"
        save_wav(str(path), w, SR)
        lines.append(f"{path}|{text}")
    (root / "list.txt").write_text("\n".join(lines) + "\n")
    return root


def _compare_items(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.shape == y.shape, k
        if k in ("mel", "energy", "pitch"):
            _report(f"dataset {k}", x, y)
        if k == "mel":
            np.testing.assert_allclose(x, y, atol=1e-4, rtol=0, err_msg=k)
        elif k == "energy":
            np.testing.assert_allclose(x, y, atol=1e-3, rtol=0, err_msg=k)
        elif k == "pitch":
            np.testing.assert_array_equal(x == 0, y == 0)
            np.testing.assert_allclose(x, y, atol=1e-3 * np.abs(y).max(), rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(x, y, err_msg=k)


def test_dataset_items_batches_and_collation_match_jax(corpus, tmp_path):
    from neuraltexttospeech_torch.data.dataset import FastPitchDataset as PortDS
    from neuraltexttospeech_tpu.data.dataset import FastPitchDataset as JaxDS

    # no arpabet: the JAX front end may find a CMUDict the port's does not look for
    kw = dict(p_arpabet=0.0, with_prior=True)
    port = PortDS(str(tmp_path / "port"), str(corpus / "list.txt"), device="cpu", **kw)
    ref = JaxDS(str(tmp_path / "jax"), str(corpus / "list.txt"), **kw)
    assert port.lengths() == ref.lengths() and len(port) == len(ref) == 5
    for i in range(len(ref)):
        _compare_items(port[i], ref[i])
    for seed in (0, 1, 2):
        for drop_last in (True, False):
            a = list(port.batches(2, seed=seed, drop_last=drop_last))
            b = list(ref.batches(2, seed=seed, drop_last=drop_last))
            assert len(a) == len(b) == (2 if drop_last else 3)
            for x, y in zip(a, b):
                _compare_items(x, y)
                assert x["text"].shape[1] % 16 == 0 and x["mel"].shape[1] % 32 == 0
    # a resumed epoch skips the batches it has done
    rest = list(port.batches(2, seed=1, skip=1))
    _compare_items(rest[0], list(ref.batches(2, seed=1))[1])
    # the caches are reused: a second dataset reads what the first wrote
    again = PortDS(str(tmp_path / "port"), str(corpus / "list.txt"), device="cpu", **kw)
    np.testing.assert_array_equal(again.get_mel(port.audiopaths_and_text[0][0]),
                                  port[0]["mel"])


def _train(tmp_path, corpus, out, *extra):
    from neuraltexttospeech_torch.cli import fastpitch_train

    return fastpitch_train.main(["-o", str(tmp_path / out), "-d", str(tmp_path / "feats"),
                                 "--training-files", str(corpus / "list.txt"), *TINY_FLAGS,
                                 "-bs", "2", "--steps-per-epoch", "1", "-lr", "1e-2",
                                 "--warmup-steps", "2", "--device", "cpu", *extra])


def test_cli_prepare_train_resume_equals_straight_run_and_infer_loads(tmp_path, corpus):
    from neuraltexttospeech_torch.cli import fastpitch_infer, fastpitch_prepare_dataset
    from neuraltexttospeech_torch.models.registry import load_checkpoint
    from neuraltexttospeech_torch.train.checkpoint import Checkpointer

    ds = fastpitch_prepare_dataset.main(["-d", str(tmp_path / "feats"), "--training-files",
                                         str(corpus / "list.txt"), "--device", "cpu"])
    assert len(list((tmp_path / "feats").glob("*_mel.npy"))) == len(ds) == 5
    assert len(list((tmp_path / "feats").glob("*_pitch.npy"))) == 5

    straight = _train(tmp_path, corpus, "straight", "--epochs", "2")
    first = _train(tmp_path, corpus, "resumed", "--epochs", "1")
    resumed = _train(tmp_path, corpus, "resumed", "--epochs", "2", "--resume")
    assert (straight["steps"], first["steps"], resumed["steps"]) == (2, 1, 1)
    drop = lambda m: {k: v for k, v in m.items() if k != "steps_per_sec"}  # noqa: E731
    assert drop(straight["metrics"]) == drop(resumed["metrics"])
    assert all(np.isfinite(v) for v in straight["metrics"].values())
    states = [Checkpointer(tmp_path / run / "checkpoints").restore()
              for run in ("straight", "resumed")]
    a, b = (s["trainer"] for s in states)
    assert a["step"] == b["step"] == 2 and states[0]["position"] == states[1]["position"]
    for k, v in a["model"].items():
        torch.testing.assert_close(b["model"][k], v, rtol=0, atol=0)
    for name in ("mu", "nu"):
        for x, y in zip(a["optimizer"][name], b["optimizer"][name]):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
    step1 = Checkpointer(tmp_path / "resumed" / "checkpoints").restore(1)["trainer"]["model"]
    assert any(not torch.equal(a["model"][k], v) for k, v in step1.items())  # it trained

    ckpt = tmp_path / "resumed" / "checkpoints" / "2"
    model, _ = load_checkpoint(ckpt, "FastPitch", torch.device("cpu"))
    trained = resumed["trainer"].model.eval()
    text = torch.randint(1, 148, (2, 16))
    with torch.no_grad():
        for x, y in zip(model.infer(text, None, max_mel_len=64),
                        trained.infer(text, None, max_mel_len=64)):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
    lines = tmp_path / "lines.txt"
    lines.write_text("Hello world.\nThe rain in Spain.\n")
    fastpitch_infer.main(["--checkpoint", str(ckpt), "-i", str(lines), "-o",
                          str(tmp_path / "mels"), "--max-mel-len", "64", "--device", "cpu"])
    for j in range(2):
        mel = np.load(tmp_path / "mels" / f"utt_{j:04d}_mel.npy")
        assert mel.ndim == 2 and mel.shape[1] == 80 and np.isfinite(mel).all()


def test_cli_host_prior_and_validation_run(tmp_path, corpus):
    from neuraltexttospeech_torch.cli import fastpitch_prepare_dataset

    fastpitch_prepare_dataset.main(["-d", str(tmp_path / "feats"), "--training-files",
                                    str(corpus / "list.txt"), "--device", "cpu"])
    run = _train(tmp_path, corpus, "hp", "--epochs", "1", "--host-prior",
                 "--validation-files", str(corpus / "list.txt"), "--optimizer", "lamb",
                 "--gradient-accumulation-steps", "2")
    assert run["steps"] == 1 and all(np.isfinite(v) for v in run["metrics"].values())
    assert len(list((tmp_path / "feats").glob("*_prior.npy"))) == 5


def test_cli_amp_trains_resumes_and_infer_loads(tmp_path, corpus):
    from neuraltexttospeech_torch.cli import fastpitch_infer, fastpitch_prepare_dataset
    from neuraltexttospeech_torch.train.checkpoint import Checkpointer

    fastpitch_prepare_dataset.main(["-d", str(tmp_path / "feats"), "--training-files",
                                    str(corpus / "list.txt"), "--device", "cpu"])
    first = _train(tmp_path, corpus, "amp", "--epochs", "1", "--amp")
    resumed = _train(tmp_path, corpus, "amp", "--epochs", "2", "--amp", "--resume")
    assert (first["steps"], resumed["steps"], resumed["trainer"].step) == (1, 1, 2)
    assert resumed["trainer"].dtype == torch.bfloat16
    for run in (first, resumed):
        assert all(np.isfinite(v) for v in run["metrics"].values())
    state = Checkpointer(tmp_path / "amp" / "checkpoints").restore()["trainer"]
    assert all(v.dtype == torch.float32 for v in state["model"].values()
               if v.is_floating_point())
    lines = tmp_path / "lines.txt"
    lines.write_text("Hello world.\n")
    fastpitch_infer.main(["--checkpoint", str(tmp_path / "amp" / "checkpoints" / "2"), "-i",
                          str(lines), "-o", str(tmp_path / "mels"), "--max-mel-len", "64",
                          "--device", "cpu", "--amp"])
    mel = np.load(tmp_path / "mels" / "utt_0000_mel.npy")
    assert mel.dtype == np.float32 and mel.shape[1] == 80 and np.isfinite(mel).all()


def test_cli_refuses_what_is_not_ported(tmp_path, corpus):
    """Nothing is left to refuse: every flag of the JAX CLI parses to the
    same value in the port's, ``--amp`` included."""
    import importlib

    from neuraltexttospeech_torch.cli import fastpitch_train

    jax_cli = importlib.import_module("fastpitch.train")
    argv = ["-o", "x", "-d", "y", "--training-files", "z", "--amp"]
    ref, ours = vars(jax_cli.parse_args(argv)), vars(fastpitch_train.parse_args(argv))
    assert set(ref) <= set(ours) and ours["amp"] is True
    assert all(ours[k] == v for k, v in ref.items()), {k: (ours[k], v) for k, v in ref.items()
                                                      if ours[k] != v}


@pytest.mark.parametrize("cli", ["fastpitch_train", "fastpitch_prepare_dataset"])
def test_cli_without_device_raises_when_no_gpu(cli, tmp_path, corpus):
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    mod = importlib.import_module(f"neuraltexttospeech_torch.cli.{cli}")
    args = ["-d", str(tmp_path / "feats"), "--training-files", str(corpus / "list.txt")]
    if cli == "fastpitch_train":
        args += ["-o", str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(args)
