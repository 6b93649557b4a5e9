"""The port's HiFi-GAN training slice against the JAX package, on the CPU.

- kernel B1's analytic backward (``ops/mel_kernel.py``) vs ``jax.grad`` of the
  JAX ``fused_frames_to_mel`` (Pallas in interpret mode, its custom VJP);
- one and two GAN steps at ``TINY`` (``tests/test_hifigan.py:16-21``) with
  ``fast_grouped_convs="gdot_pallas"``, from the same weights (carried across
  by ``convert.hifigan_train_from_flax``) and batch: metrics at rtol 2e-4 /
  atol 2e-5, the updated G, MPD and MSD at rtol 3e-3 / atol 3e-5, as
  ``test_hifigan.py:211-217``, and the spectral-norm stats;
- an audio-only batch gives the step of host mels (``test_hifigan.py:220-248``);
- the learning rate follows optax ``exponential_decay``.

The dataset and the trainer CLI are in ``test_torch_hifigan_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraltexttospeech_torch.convert import hifigan_train_from_flax
from neuraltexttospeech_torch.models import hifigan as port_hg
from neuraltexttospeech_torch.models import hifigan_gan as port_gan
from neuraltexttospeech_tpu.models import hifigan as jax_hg
from neuraltexttospeech_tpu.models import hifigan_gan as jax_gan

TINY = dict(resblock="2", upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
            upsample_initial_channel=32, resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 2),), n_fft=64, hop_size=16, win_size=64,
            segment_size=256, num_mels=8, fast_grouped_convs="gdot_pallas")
METRIC_TOL = dict(rtol=2e-4, atol=2e-5)
PARAM_TOL = dict(rtol=3e-3, atol=3e-5)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("power", [0.5, 2.0])
def test_mel_backward_matches_jax_grad(power):
    from neuraltexttospeech_torch.audio.stft import STFTConfig as PortSTFT
    from neuraltexttospeech_torch.audio.stft import windowed_frames
    from neuraltexttospeech_torch.ops import mel_kernel as port_mel
    from neuraltexttospeech_tpu.audio.stft import STFTConfig as JaxSTFT
    from neuraltexttospeech_tpu.ops import mel_kernel as jax_mel

    x = torch.as_tensor(np.random.default_rng(4).standard_normal(11025).astype(np.float32) * 0.2)
    frames = windowed_frames(x, 1024, 256, 1024).contiguous()
    frames[3] = 0.0  # |X|^2 = 0 everywhere and every mel below the clip
    f_np = frames.numpy().copy()
    g_jax = np.asarray(jax.grad(lambda f: jnp.sum(jnp.cos(jax_mel.fused_frames_to_mel(
        f, JaxSTFT(magnitude_power=power)))))(jnp.asarray(f_np)))
    ft = frames.clone().requires_grad_()
    torch.sum(torch.cos(port_mel.fused_frames_to_mel(ft, PortSTFT(magnitude_power=power)))
              ).backward()
    g = ft.grad.numpy()
    assert np.isfinite(g).all() and not g[3].any()
    scale = np.abs(g_jax).max()
    np.testing.assert_allclose(g / scale, g_jax / scale, atol=1e-4)


def _jax_state(cfg):
    return jax_gan.init_hifigan(cfg, jax.random.PRNGKey(0))


def _port_trainer(state, cfg: port_hg.HiFiGANConfig):
    trainer = port_gan.HiFiGANTrainer(cfg, CPU, steps_per_epoch=1000)
    gen, mpd, msd = hifigan_train_from_flax(_np(state.gen_params), _np(state.mpd_params),
                                            _np(state.msd_params), _np(state.msd_stats))
    trainer.gen.load_state_dict(gen)
    trainer.mpd.load_state_dict(mpd)
    trainer.msd.load_state_dict(msd)
    return trainer


def _batch(seed, B=2, frames=16):
    rng = np.random.default_rng(seed)
    batch = {"mel": rng.standard_normal((B, frames, 8)).astype(np.float32),
             "audio": (rng.standard_normal((B, frames * 16, 1)) * 0.1).astype(np.float32)}
    batch["mel_loss"] = np.asarray(jax_gan.mel_for_loss(
        jnp.asarray(batch["audio"][..., 0]), jax_gan.loss_stft_config(jax_hg.HiFiGANConfig(
            **{k: v for k, v in TINY.items() if k != "fast_grouped_convs"}))))
    return batch


def test_gan_steps_match_jax():
    jcfg = jax_hg.HiFiGANConfig(**TINY)
    state = _jax_state(jcfg)
    trainer = _port_trainer(state, port_hg.HiFiGANConfig(**TINY))
    assert trainer.msd_group_impl == "gouter"
    for step in range(2):
        batch = _batch(7 + step)
        state, want = jax_gan.hifigan_train_step(jcfg, state, {k: jnp.asarray(v) for k, v
                                                               in batch.items()})
        got = trainer.train_step({k: torch.tensor(v) for k, v in batch.items()})
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), err_msg=f"{step}:{k}",
                                       **METRIC_TOL)
        ref = hifigan_train_from_flax(_np(state.gen_params), _np(state.mpd_params),
                                      _np(state.msd_params), _np(state.msd_stats))
        for module, sd in zip((trainer.gen, trainer.mpd, trainer.msd), ref):
            ours = module.state_dict()
            assert set(sd) <= set(ours)
            for key, value in sd.items():
                tol = dict(rtol=1e-4, atol=1e-6) if ".sn." in key else PARAM_TOL
                np.testing.assert_allclose(ours[key].numpy(), value.numpy(),
                                           err_msg=f"{step}:{key}", **tol)
    assert trainer.step == int(state.step) == 2


def test_audio_only_batch_matches_host_mels():
    cfg = port_hg.HiFiGANConfig(**TINY)
    rng = np.random.default_rng(9)
    audio = torch.as_tensor((rng.standard_normal((2, cfg.segment_size, 1)) * 0.1)
                            .astype(np.float32))
    host = {"audio": audio,
            "mel": port_gan.mel_for_loss(audio[..., 0], port_gan.input_stft_config(cfg)),
            "mel_loss": port_gan.mel_for_loss(audio[..., 0], port_gan.loss_stft_config(cfg))}
    out = {}
    for name, batch in (("host", host), ("audio_only", {"audio": audio})):
        trainer = port_gan.HiFiGANTrainer(cfg, CPU)
        out[name] = (trainer.train_step(batch), trainer.gen.state_dict())
    for k in out["host"][0]:
        np.testing.assert_allclose(float(out["audio_only"][0][k]), float(out["host"][0][k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    for k, v in out["host"][1].items():
        np.testing.assert_allclose(out["audio_only"][1][k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("step", [0, 1, 2, 3, 7, 3000])
def test_learning_rate_follows_optax_exponential_decay(step):
    import optax

    cfg = port_hg.HiFiGANConfig(**TINY)
    sched = optax.exponential_decay(cfg.learning_rate, 3, cfg.lr_decay)
    # rtol 1e-4: optax evaluates the power in f32, the port in f64
    np.testing.assert_allclose(port_gan.learning_rate(cfg, step, 3), float(sched(step)),
                               rtol=1e-4)
