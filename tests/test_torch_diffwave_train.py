"""DiffWave training in the port against the JAX package, on the CPU.

- ``train/harness.py::Trainer`` with the DiffWave loss (``cli/diffwave_train.
  make_loss_fn``), 1 and 2 steps against the JAX ``Trainer`` from the
  golden's weights: each step's ``t`` and noise are JAX's (its per-step key
  ``fold_in(key(seed, "rbg"), step)`` split as ``diffwave_loss`` splits it),
  fed to the port through the batch; metrics at rtol 2e-4, parameters at
  rtol 3e-3 / atol 3e-5 (``tests/test_hifigan.py:211-217``'s tolerances);
- one bf16 step (``--amp``) by the yardstick of ``test_torch_bf16.py``:
  metrics, the gradients (read from Adam's first moment) and the updated
  parameters within 2.5 lr;
- ``VocoderDataset.batches(shuffle=False, drop_last=False)``, the
  validation loop's call, equal to JAX's; ``device=`` keeps the mels as
  tensors on that device;
- the CLIs at a tiny size: ``diffwave_train`` (with validation) for 2 epochs
  equals 1 epoch then ``--resume`` bit for bit, ``--amp`` trains and
  resumes, and ``diffwave_infer --fast`` (whole and ``--chunked``) writes
  finite wavs of the mel's length.
"""

import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from neuraltexttospeech_torch.cli import diffwave_infer, diffwave_train  # noqa: E402
from neuraltexttospeech_torch.convert import diffwave_from_flax  # noqa: E402
from neuraltexttospeech_torch.models import diffwave as port_dw  # noqa: E402
from neuraltexttospeech_torch.train import harness as port_harness  # noqa: E402
from neuraltexttospeech_torch.train import state as port_state  # noqa: E402
from neuraltexttospeech_tpu.models import diffwave as jax_dw  # noqa: E402
from neuraltexttospeech_tpu.train import harness as jax_harness  # noqa: E402
from neuraltexttospeech_tpu.train import state as jax_state  # noqa: E402
from test_torch_bf16 import _param_bound, adam_grads, grads_yardstick, yardstick  # noqa: E402
from tools.make_goldens import GOLDEN_DIR  # noqa: E402

SMALL = dict(residual_layers=4, residual_channels=8, dilation_cycle_length=2, crop_mel_frames=4)
OPT = dict(learning_rate=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, grad_clip_norm=None)
SEED = 1234


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def golden_params():
    from flax import serialization

    return serialization.msgpack_restore((GOLDEN_DIR / "diffwave.msgpack").read_bytes())


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"audio": (rng.standard_normal((3, 1024, 1)) * 0.1).astype(np.float32),
            "mel": rng.standard_normal((3, 4, 80)).astype(np.float32)}


def _jax_step_draws(step, batch):
    """The ``t`` and noise of JAX Trainer step ``step`` (default seed, rbg)."""
    rng = jax.random.fold_in(jax.random.key(SEED, impl="rbg"), step)
    t_rng, n_rng = jax.random.split(rng)
    B, S = batch["audio"].shape[:2]
    return (torch.as_tensor(np.asarray(jax.random.randint(t_rng, (B,), 0, 50))),
            torch.as_tensor(np.asarray(jax.random.normal(n_rng, (B, S)))))


def _jax_trainer(params, dtype=None):
    model = jax_dw.DiffWave(jax_dw.DiffWaveConfig(**SMALL, dtype=dtype))

    def loss_fn(p, batch, rng):
        return jax_dw.diffwave_loss(model, p, {"audio": batch["audio"][..., 0],
                                               "mel": batch["mel"]}, rng)

    cfg = jax_state.OptimizerConfig(**OPT)
    return jax_harness.Trainer(loss_fn, jax_state.TrainState.create(
        params, jax_state.make_optimizer(cfg)),
        jax_harness.TrainerConfig(optimizer=cfg, seed=SEED, log_every=10 ** 9))


def _port_trainer(params, dtype=None):
    model = port_dw.DiffWave(port_dw.DiffWaveConfig(**SMALL))
    model.load_state_dict(diffwave_from_flax(params))
    return port_harness.Trainer(
        diffwave_train.make_loss_fn(False), model,
        port_harness.TrainerConfig(optimizer=port_state.OptimizerConfig(**OPT), seed=SEED,
                                   log_every=10 ** 9), "cpu", dtype=dtype)


def _port_batch(step, batch):
    t, noise = _jax_step_draws(step, batch)
    return {**{k: torch.as_tensor(v) for k, v in batch.items()}, "t": t, "noise": noise}


def test_trainer_steps_match_jax_trainer(golden_params):
    ref, ours = _jax_trainer(golden_params), _port_trainer(golden_params)
    start = {k: v.clone() for k, v in ours.model.state_dict().items()}
    for step, batch in enumerate([_batch(1), _batch(2)]):
        want = {k: float(v) for k, v in ref.train_step(batch).items()}
        got = ours.train_step(_port_batch(step, batch))
        assert ours.step == ref.step == step + 1
        assert sorted(got) == sorted(want) == ["grad_norm", "l1_noise", "loss"]
        for k, v in want.items():
            print(f"step {step + 1} {k}: port {float(got[k]):.6e}, JAX {v:.6e}")
            np.testing.assert_allclose(float(got[k]), v, rtol=2e-4, err_msg=f"{step} {k}")
        jax_sd = diffwave_from_flax(_np(ref.state.params))
        sd = ours.model.state_dict()
        assert sorted(sd) == sorted(jax_sd)
        worst = max((sd[k] - jax_sd[k]).abs().max().item() for k in sd)
        print(f"step {step + 1} parameters: max |port - JAX| {worst:.3e}")
        for k, v in sd.items():
            np.testing.assert_allclose(v.numpy(), jax_sd[k].numpy(), rtol=3e-3, atol=3e-5,
                                       err_msg=f"step {step + 1} {k}")
    assert max((sd[k] - start[k]).abs().max().item() for k in sd) > 1e-4  # the steps moved


def test_trainer_step_bf16_matches_jax(golden_params):
    batch = _batch(3)
    steps = {}
    for dt in (jax.numpy.bfloat16, None):
        trainer = _jax_trainer(golden_params, dt)
        metrics = {k: float(v) for k, v in trainer.train_step(batch).items()}
        steps[dt] = (metrics, diffwave_from_flax(_np(trainer.state.params)),
                     diffwave_from_flax(adam_grads(trainer.state.opt_state, OPT["beta1"])))
    (want_b, sd_b, g_b), (want_f, _, g_f) = steps[jax.numpy.bfloat16], steps[None]
    ours = _port_trainer(golden_params, torch.bfloat16)
    got = ours.train_step(_port_batch(0, batch))
    for k in want_b:
        yardstick(f"DiffWave step {k}", float(got[k]), want_b[k], want_f[k])
    names = [n for n, p in ours.model.named_parameters() if p.requires_grad]
    grads_yardstick("DiffWave step gradients",
                    {n: (m / (1.0 - OPT["beta1"])).numpy()
                     for n, m in zip(names, ours.optimizer.mu)},
                    {n: g_b[n].numpy() for n in names}, {n: g_f[n].numpy() for n in names})
    sd = ours.model.state_dict()
    assert all(v.dtype == torch.float32 for v in sd.values())
    _param_bound("DiffWave step parameters", sd, {k: sd_b[k] for k in sd}, OPT["learning_rate"])


@pytest.fixture()
def wav_filelist(tmp_path):
    from neuraltexttospeech_torch.data.filelist import save_wav

    rng = np.random.default_rng(0)
    paths = []
    for i, n in enumerate((2205, 1800, 700, 3000, 1500)):
        p = tmp_path / "wavs" / f"utt{i}.wav"
        save_wav(str(p), rng.standard_normal(n) * 0.1, 22050)
        paths.append(str(p))
    fl = tmp_path / "list.txt"
    fl.write_text("\n".join(f"{p}|text" for p in paths) + "\n")
    return str(fl)


def test_unshuffled_batches_match_jax(wav_filelist):
    from neuraltexttospeech_torch.data.mel_dataset import VocoderDataset as PortDS
    from neuraltexttospeech_tpu.data.mel_dataset import VocoderDataset as JaxDS

    kw = dict(segment_size=1024, hop_size=256, num_mels=80, seed=12)
    port, ref = PortDS(wav_filelist, **kw), JaxDS(wav_filelist, **kw)
    for shuffle, drop_last in ((False, False), (False, True), (True, False)):
        a = list(port.batches(2, shuffle=shuffle, seed=3, drop_last=drop_last))
        b = list(ref.batches(2, shuffle=shuffle, seed=3, drop_last=drop_last))
        assert [len(x["audio"]) for x in a] == [len(x["audio"]) for x in b] == (
            [2, 2, 1] if not drop_last else [2, 2])
        for x, y in zip(a, b):
            assert sorted(x) == sorted(y)
            np.testing.assert_array_equal(x["audio"], y["audio"])
            for k in ("mel", "mel_loss"):
                np.testing.assert_allclose(x[k], np.asarray(y[k]), atol=1e-3, rtol=1e-4)


def test_dataset_device_keeps_the_mels_there(wav_filelist):
    from neuraltexttospeech_torch.data.mel_dataset import VocoderDataset

    kw = dict(segment_size=1024, hop_size=256, num_mels=80, seed=12)
    host = list(VocoderDataset(wav_filelist, **kw).batches(2, seed=1))
    dev = list(VocoderDataset(wav_filelist, device="cpu", **kw).batches(2, seed=1))
    assert len(host) == len(dev) == 2
    for x, y in zip(host, dev):  # the same crops and mels, as f32 tensors on the CPU
        assert sorted(x) == sorted(y) == ["audio", "mel", "mel_loss"]
        for k in x:
            assert x[k].device.type == y[k].device.type == "cpu"
            assert x[k].dtype == y[k].dtype == torch.float32
            torch.testing.assert_close(x[k], y[k], atol=0, rtol=0)


def _train(out, filelist, *extra):
    return diffwave_train.main(["-o", str(out), "--training-files", filelist,
                                "--validation-files", filelist, "--residual-layers", "2",
                                "--residual-channels", "8", "--crop-mel-frames", "4",
                                "--batch-size", "2", "--steps-per-epoch", "1",
                                "--device", "cpu", *extra])


def test_cli_train_resume_and_infer(wav_filelist, tmp_path):
    straight = _train(tmp_path / "a", wav_filelist, "--epochs", "2")
    first = _train(tmp_path / "b", wav_filelist, "--epochs", "1")
    resumed = _train(tmp_path / "b", wav_filelist, "--epochs", "2", "--resume")
    assert (straight["steps"], first["steps"], resumed["steps"]) == (2, 1, 1)
    assert resumed["trainer"].step == 2
    assert np.isfinite(resumed["val"]["l1_noise"]) and np.isfinite(resumed["metrics"]["loss"])
    a, b = (torch.load(tmp_path / r / "checkpoints" / "2" / "train_state.pt",
                       weights_only=False)["trainer"] for r in ("a", "b"))
    for k, v in a["model"].items():
        torch.testing.assert_close(b["model"][k], v, rtol=0, atol=0)

    mels = tmp_path / "mels"
    mels.mkdir()
    rng = np.random.default_rng(4)
    np.save(mels / "m6.npy", rng.standard_normal((6, 80)).astype(np.float32))
    np.save(mels / "m9.npy", rng.standard_normal((1, 9, 80)).astype(np.float32))
    from scipy.io import wavfile

    for flags in (["--fast"], ["--fast", "--chunked"]):
        out = tmp_path / ("wav_" + "_".join(f.strip("-") for f in flags))
        diffwave_infer.main(["--checkpoint", str(tmp_path / "b" / "checkpoints" / "2"),
                             "-i", str(mels), "-o", str(out), "--device", "cpu", *flags])
        for name, frames in (("m6", 6), ("m9", 9)):
            sr, audio = wavfile.read(out / f"{name}.wav")
            assert sr == 22050 and audio.shape == (frames * 256,), (flags, audio.shape)
            assert np.isfinite(audio).all()


def test_cli_amp_trains_and_resumes(wav_filelist, tmp_path):
    first = _train(tmp_path / "c", wav_filelist, "--epochs", "1", "--amp")
    resumed = _train(tmp_path / "c", wav_filelist, "--epochs", "2", "--amp", "--resume")
    assert (first["steps"], resumed["steps"], resumed["trainer"].step) == (1, 1, 2)
    assert resumed["trainer"].dtype == torch.bfloat16
    assert all(np.isfinite(v) for v in resumed["metrics"].values())
    state = torch.load(tmp_path / "c" / "checkpoints" / "2" / "train_state.pt",
                       weights_only=False)
    assert all(v.dtype == torch.float32 for v in state["trainer"]["model"].values())
    model, config = diffwave_infer.load_checkpoint(tmp_path / "c" / "checkpoints" / "2",
                                                   "DiffWave", torch.device("cpu"))
    assert config.residual_layers == 2 and isinstance(model, port_dw.DiffWave)
