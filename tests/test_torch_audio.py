"""The port's log-mel front-end against the JAX package's, both paths.

- window and filterbank: the numpy copies agree to 1e-7;
- plain ``mel_spectrogram`` (rFFT) vs JAX ``use_pallas=False``: 1e-4 abs;
- ``frames_to_mel_reference`` (the kernel's plain twin) vs the JAX Pallas
  kernel in interpret mode: ``atol=1e-3, rtol=1e-4``, the log-mel budget of
  ``tests/test_audio.py``.

The CUDA kernel itself is held against its twin in ``test_torch_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraltexttospeech_torch.audio import mel as port_mel
from neuraltexttospeech_torch.audio import stft as port_stft
from neuraltexttospeech_torch.ops import mel_kernel as port_kernel
from neuraltexttospeech_tpu.audio import mel as jax_mel
from neuraltexttospeech_tpu.audio import stft as jax_stft
from neuraltexttospeech_tpu.ops import mel_kernel as jax_kernel

CONFIGS = {
    "default": dict(),
    "small": dict(filter_length=64, frame_length=64, frame_step=16, n_mel_channels=8),
}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _configs(name, power):
    kw = dict(CONFIGS[name], magnitude_power=power)
    return port_stft.STFTConfig(**kw), jax_stft.STFTConfig(**kw)


def _signal(seed, n):
    return (np.random.default_rng(seed).standard_normal(n) * 0.2).astype(np.float32)


@pytest.mark.parametrize("n", [16, 64, 1024])
def test_window_and_filterbank_match_jax(n):
    np.testing.assert_allclose(port_mel.hann_window(n), jax_mel.hann_window(n), atol=1e-7)
    args = dict(num_mel_bins=8 if n < 1024 else 80, num_spectrogram_bins=n // 2 + 1)
    np.testing.assert_allclose(port_mel.linear_to_mel_weight_matrix(**args),
                               jax_mel.linear_to_mel_weight_matrix(**args), atol=1e-7)


def _mel_f64(x, cfg):
    """The log-mel in float64 numpy (rFFT, power, basis, log): the arbiter
    both paths are held to, so a failure says which side is off."""
    frames = np.lib.stride_tricks.sliding_window_view(x.astype(np.float64), cfg.frame_length,
                                                      axis=-1)[..., ::cfg.frame_step, :]
    spec = np.abs(np.fft.rfft(frames * port_mel.hann_window(cfg.frame_length, dtype=np.float64),
                              n=cfg.filter_length, axis=-1))
    return np.log(np.maximum(spec ** cfg.magnitude_power @ cfg.mel_basis().astype(np.float64),
                             1e-5))


def _log_mels(x, name, power):
    """(port, JAX, float64) log-mels of ``x`` by the plain rFFT paths."""
    ours_cfg, ref_cfg = _configs(name, power)
    ours = port_stft.mel_spectrogram(torch.as_tensor(x), ours_cfg).numpy()
    ref = np.asarray(jax_stft.mel_spectrogram(jnp.asarray(x), ref_cfg, use_pallas=False))
    return ours, ref, _mel_f64(x, ours_cfg)


@pytest.fixture(scope="module")
def _first_calls():
    """Each config's first log-mels in this module, both paths, before any
    other call here: a fault that shows only in a library's first transform
    of a size in a process (ROADMAP §C) is held to the budget below too."""
    x = _signal(0, (1, 2048))
    return {(name, power): _log_mels(x, name, power)
            for name in CONFIGS for power in (0.5, 2.0)}


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("power", [0.5, 2.0])
def test_plain_mel_matches_jax_rfft_path(name, power, _first_calls):
    later = _log_mels(_signal(1, (2, 6000)), name, power)
    for when, (ours, ref, exact) in (("first call", _first_calls[(name, power)]),
                                     ("later call", later)):
        assert ours.shape == ref.shape == exact.shape
        off = f"{when}: against float64, port {np.abs(ours - exact).max():.3e}, JAX " \
              f"{np.abs(ref - exact).max():.3e}"
        np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=0, err_msg=off)
        np.testing.assert_allclose(ours, exact, atol=1e-4, rtol=0, err_msg=off)
        np.testing.assert_allclose(ref, exact, atol=1e-4, rtol=0, err_msg=off)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("power", [0.5, 2.0])
def test_kernel_twin_matches_jax_pallas_kernel(name, power):
    ours_cfg, ref_cfg = _configs(name, power)
    x = _signal(2, 8000)
    frames = port_stft.windowed_frames(torch.as_tensor(x), ours_cfg.frame_length,
                                       ours_cfg.frame_step, ours_cfg.filter_length)
    ours = port_kernel.frames_to_mel_reference(frames, ours_cfg).numpy()
    ref = np.asarray(jax_kernel.fused_frames_to_mel(jnp.asarray(frames.numpy()), ref_cfg))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=1e-3, rtol=1e-4)
    # the twin and the rFFT path are two independent forms of one function
    plain = port_stft.mel_spectrogram(torch.as_tensor(x), ours_cfg).numpy()
    np.testing.assert_allclose(ours, plain, atol=1e-3, rtol=1e-4)


def test_cpu_tensor_takes_the_plain_twin_and_launches_nothing():
    cfg = port_stft.STFTConfig()
    x = torch.as_tensor(_signal(3, 5000))
    before = port_kernel.fused_frames_to_mel.launches
    fused = port_kernel.fused_mel_spectrogram(x, cfg)
    frames = port_stft.windowed_frames(x, 1024, 256, 1024)
    torch.testing.assert_close(fused, port_kernel.frames_to_mel_reference(frames, cfg),
                               atol=0, rtol=0)
    assert port_kernel.fused_frames_to_mel.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        port_stft.mel_spectrogram(x, cfg, use_kernel=True)


def test_stft_shim_batched_and_squeezed():
    stft = port_stft.STFT(device="cpu")
    x = np.random.default_rng(3).standard_normal((2, 22050)).astype(np.float32)
    mel = stft.mel_spectrogram(x)
    assert mel.shape == (2, port_stft.num_frames(22050, 1024, 256), 80)
    single = stft.mel_spectrogram(x[0])
    torch.testing.assert_close(mel[0], single, atol=1e-5, rtol=0)
    torch.testing.assert_close(stft.mel_spectrogram(x[:1]), single, atol=1e-5, rtol=0)


def test_frame_signal_short_input_has_no_frames():
    x = torch.zeros(100)
    assert port_stft.frame_signal(x, 1024, 256).shape == (0, 1024)
    assert port_stft.num_frames(100, 1024, 256) == 0
