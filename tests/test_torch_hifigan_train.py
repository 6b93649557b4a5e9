"""The port's HiFi-GAN trainer CLI and vocoder dataset, on the CPU.

- ``VocoderDataset`` draws the same crops as the JAX package's for a seed,
  and its host mels agree with JAX's (1e-4, the rFFT log-mel budget of
  ``tests/test_torch_audio.py``); in fine-tuning mode (acoustic-model mels)
  the same mel and audio crops bit for bit, and loss mels within the
  log-mel budget (1e-3: the port's fused log-mel against JAX's rFFT);
- ``cli/hifigan_train.py`` at ``TINY`` (``tests/test_hifigan.py:16-21``) on
  synthetic wavs: 2 steps straight equal 1 step, save, ``--resume``, 1 step
  (bit for bit: the same ops on the CPU), and ``cli/hifigan_infer.py`` loads
  the trained generator; with ``--amp`` (bf16) 1 step, ``--resume``, 1 step,
  f32 checkpoints, and the loader reads them; one step on
  ``--fine-tuning-mel-dir``;
- the TPU-only MSD lowerings raise as not ported, and an old
  ``model_config.json`` without the training fields still loads.
"""

import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

from neuraltexttospeech_torch.models import hifigan as port_hg

TINY = dict(resblock="2", upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
            upsample_initial_channel=32, resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 2),), n_fft=64, hop_size=16, win_size=64,
            segment_size=256, num_mels=8, fast_grouped_convs="gdot_pallas")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture()
def wav_filelist(tmp_path):
    from neuraltexttospeech_torch.data.filelist import save_wav

    rng = np.random.default_rng(0)
    paths = []
    for i, n in enumerate((2205, 1800, 400, 3000)):
        p = tmp_path / "wavs" / f"utt{i}.wav"
        save_wav(str(p), rng.standard_normal(n) * 0.1, 22050)
        paths.append(str(p))
    fl = tmp_path / "list.txt"
    fl.write_text("\n".join(f"{p}|text" for p in paths) + "\n")
    return str(fl)


def test_dataset_crops_and_mels_match_jax(wav_filelist):
    from neuraltexttospeech_torch.data.mel_dataset import VocoderDataset as PortDS
    from neuraltexttospeech_tpu.data.mel_dataset import VocoderDataset as JaxDS

    kw = dict(segment_size=512, n_fft=256, hop_size=64, win_size=256, num_mels=16, seed=11)
    port, ref = PortDS(wav_filelist, **kw), JaxDS(wav_filelist, **kw)
    for epoch in range(3):
        for audio_only in (True, False):
            for a, b in zip(port.batches(2, seed=epoch, audio_only=audio_only),
                            ref.batches(2, seed=epoch, audio_only=audio_only)):
                assert sorted(a) == sorted(b)
                np.testing.assert_array_equal(a["audio"], b["audio"])
                if not audio_only:
                    np.testing.assert_allclose(a["mel"], b["mel"], atol=1e-4)
                    np.testing.assert_allclose(a["mel_loss"], b["mel_loss"], atol=1e-4)
    # batch larger than the corpus: sampled with replacement, as in JAX
    a = list(port.batches(6, seed=3, max_batches=2, audio_only=True))
    b = list(ref.batches(6, seed=3, max_batches=2, audio_only=True))
    assert len(a) == len(b) == 2
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["audio"], y["audio"])
    # fine-tuning mode: acoustic-model mels, one shorter than the crop
    mel_dir = _fine_tuning_mels(wav_filelist, kw["hop_size"], kw["num_mels"])
    port, ref = (cls(wav_filelist, fine_tuning_mel_dir=mel_dir, **kw) for cls in (PortDS, JaxDS))
    for epoch in range(3):
        for a, b in zip(port.batches(2, seed=epoch), ref.batches(2, seed=epoch)):
            assert sorted(a) == sorted(b)
            np.testing.assert_array_equal(a["audio"], b["audio"])
            np.testing.assert_array_equal(a["mel"], b["mel"])
            np.testing.assert_allclose(a["mel_loss"], b["mel_loss"], atol=1e-3)


def _fine_tuning_mels(filelist, hop, n_mels):
    """``<utt>_mel.npy`` beside each wav of ``filelist``: random mels of the
    wav's frame count, the first cut short (8 frames) so that its crop pads."""
    import pathlib

    paths = [line.split("|")[0] for line in pathlib.Path(filelist).read_text().splitlines()]
    mel_dir = pathlib.Path(filelist).parent / "ft_mels"
    mel_dir.mkdir(exist_ok=True)
    rng = np.random.default_rng(5)
    for i, p in enumerate(paths):
        import scipy.io.wavfile

        _, wav = scipy.io.wavfile.read(p)
        frames = 8 if i == 0 else len(wav) // hop
        np.save(mel_dir / pathlib.Path(p).name.replace(".wav", "_mel.npy"),
                rng.standard_normal((frames, n_mels)).astype(np.float32))
    return str(mel_dir)


def _train(tmp_path, out, *extra, config=TINY):
    from neuraltexttospeech_torch.cli import hifigan_train

    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(config))
    return hifigan_train.main(["--config", str(cfg), "-o", str(tmp_path / out),
                               "--training-files", str(tmp_path / "list.txt"),
                               "--batch-size", "2", "--steps-per-epoch", "1",
                               "--device", "cpu", *extra])


def test_cli_resume_equals_straight_run_and_infer_loads(tmp_path, wav_filelist):
    from neuraltexttospeech_torch.cli import hifigan_infer
    from neuraltexttospeech_torch.train.checkpoint import Checkpointer

    straight = _train(tmp_path, "straight", "--epochs", "2")
    first = _train(tmp_path, "resumed", "--epochs", "1")
    assert first["steps"] == 1
    resumed = _train(tmp_path, "resumed", "--epochs", "2", "--resume")
    assert resumed["steps"] == 1 and straight["steps"] == 2
    assert straight["metrics"] == resumed["metrics"]
    assert all(np.isfinite(v) for v in straight["metrics"].values())
    states = [Checkpointer(tmp_path / run / "checkpoints").restore()
              for run in ("straight", "resumed")]
    for a, b in zip(states, states[1:]):
        assert a["trainer"]["step"] == b["trainer"]["step"] == 2
        for name in ("gen", "mpd", "msd"):
            for k, v in a["trainer"][name].items():
                torch.testing.assert_close(b["trainer"][name][k], v, rtol=0, atol=0)
    ckpt = tmp_path / "resumed" / "checkpoints" / "2"
    mel_dir = tmp_path / "mels"
    mel_dir.mkdir()
    np.save(mel_dir / "utt_mel.npy", np.random.default_rng(0).standard_normal((12, 8))
            .astype(np.float32))
    hifigan_infer.main(["--checkpoint", str(ckpt), "-i", str(mel_dir),
                        "-o", str(tmp_path / "wavs_out"), "--device", "cpu"])
    from scipy.io import wavfile

    sr, audio = wavfile.read(tmp_path / "wavs_out" / "utt_mel.wav")
    assert sr == 22050 and audio.shape == (12 * 16,)
    # the serving checkpoint is the trained generator with weight norm folded
    gen, _ = hifigan_infer.load_generator(ckpt, CPU)
    mel = torch.randn(1, 12, 8)
    with torch.no_grad():
        torch.testing.assert_close(gen(mel), resumed["trainer"].gen(mel), rtol=1e-5, atol=1e-6)


def test_cli_amp_trains_resumes_and_infer_loads(tmp_path, wav_filelist):
    """``--amp``: bf16 compute, f32 parameters and Adam state in the
    checkpoint, a resume that continues, and a serving checkpoint that the
    loader reads in either mode."""
    from neuraltexttospeech_torch.cli import hifigan_infer
    from neuraltexttospeech_torch.train.checkpoint import Checkpointer

    first = _train(tmp_path, "amp", "--epochs", "1", "--amp")
    resumed = _train(tmp_path, "amp", "--epochs", "2", "--amp", "--resume")
    assert (first["steps"], resumed["steps"], resumed["trainer"].step) == (1, 1, 2)
    assert resumed["trainer"].dtype == torch.bfloat16
    for run in (first, resumed):
        assert run["metrics"] and all(np.isfinite(v) for v in run["metrics"].values())
    state = Checkpointer(tmp_path / "amp" / "checkpoints").restore()["trainer"]
    for name in ("gen", "mpd", "msd"):
        assert all(v.dtype == torch.float32 for v in state[name].values()
                   if v.is_floating_point())
        for s in state["optimizers"][name]["state"].values():
            assert all(v.dtype == torch.float32 for k, v in s.items() if k != "step")
    ckpt = tmp_path / "amp" / "checkpoints" / "2"
    gen, _ = hifigan_infer.load_generator(ckpt, CPU)
    mel = torch.randn(1, 12, 8)
    with torch.no_grad():
        torch.testing.assert_close(gen(mel), resumed["trainer"].gen(mel), rtol=1e-5, atol=1e-6)
    audio = hifigan_infer.vocode(gen, mel, torch.bfloat16)
    assert audio.dtype == torch.float32 and torch.isfinite(audio).all()
    shutil.rmtree(tmp_path / "amp")  # ~0.9 GB a checkpoint: the full MPD and MSD with Adam


def test_cli_fine_tuning_mel_dir_trains(tmp_path, wav_filelist):
    mel_dir = _fine_tuning_mels(wav_filelist, TINY["hop_size"], TINY["num_mels"])
    run = _train(tmp_path, "ft", "--epochs", "1", "--fine-tuning-mel-dir", mel_dir)
    assert run["steps"] == 1 and all(np.isfinite(v) for v in run["metrics"].values())
    shutil.rmtree(tmp_path / "ft")


def test_cli_refuses_what_is_not_ported(tmp_path, wav_filelist):
    """Every flag of the JAX CLI is ported; the MSD lowerings that exist only
    for the TPU are refused."""
    for lowering in ("bgc", "folded", True):
        with pytest.raises(NotImplementedError, match="not ported"):
            _train(tmp_path, "x", "--epochs", "1",
                   config=dict(TINY, fast_grouped_convs=lowering))


def test_old_model_config_without_training_fields_loads(tmp_path):
    from neuraltexttospeech_torch.models.registry import load_model_config

    cfg = port_hg.HiFiGANConfig.v1()
    old = {k: v for k, v in dataclasses.asdict(cfg).items()
           if k in ("resblock", "upsample_rates", "num_mels", "n_fft", "hop_size")}
    (tmp_path / "model_config.json").write_text(json.dumps({"model": "HiFiGAN",
                                                            "config": old}))
    name, loaded = load_model_config(tmp_path)
    assert name == "HiFiGAN" and loaded == cfg


def test_cli_without_device_raises_when_no_gpu(tmp_path):
    from neuraltexttospeech_torch.cli import hifigan_train

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hifigan_train.main(["-o", str(tmp_path / "out"),
                            "--training-files", str(tmp_path / "list.txt")])


def test_prefetch_keeps_order_passes_values_and_raises_producer_errors():
    from neuraltexttospeech_torch.data.prefetch import prefetch

    def items(n, fail_at=None):
        for i in range(n):
            if i == fail_at:
                raise KeyError("producer failed")
            yield {"x": np.full((2, 3), i, np.float32), "tag": ("pos", i)}

    got = list(prefetch(items(50), CPU, buffer_size=2))
    assert [b["tag"] for b in got] == [("pos", i) for i in range(50)]
    assert all(isinstance(b["x"], torch.Tensor) and b["x"][0, 0] == i for i, b in enumerate(got))
    with pytest.raises(KeyError, match="producer failed"):
        list(prefetch(items(10, fail_at=4), CPU))


def test_checkpointer_is_idempotent_keeps_the_newest_and_restores(tmp_path):
    from neuraltexttospeech_torch.train.checkpoint import Checkpointer

    ckpt = Checkpointer(tmp_path / "ck", max_to_keep=2, save_interval_steps=3)
    assert ckpt.latest_step() is None
    assert not ckpt.save(2, {"step": 2})             # not on the interval
    assert ckpt.save(2, {"step": 2}, force=True)
    assert not ckpt.save(2, {"step": -1}, force=True)  # exists: kept as it was
    for step in (3, 6):
        assert ckpt.save(step, {"step": step})
    assert ckpt.all_steps() == [3, 6] and ckpt.latest_step() == 6
    assert ckpt.restore()["step"] == 6 and ckpt.restore(3)["step"] == 3
    with pytest.raises(FileNotFoundError):
        Checkpointer(tmp_path / "empty").restore()
