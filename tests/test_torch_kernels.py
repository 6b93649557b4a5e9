"""The port's CUDA kernels against their plain PyTorch twins.

The tests marked ``gpu`` need the card and skip without one. This file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_kernels.py --noconftest -m gpu

(``--noconftest`` skips ``tests/conftest.py``, which sets JAX up.) The
others check, on the CPU, the host side that the kernel relies on.
"""

import numpy as np
import pytest
import torch

from neuraltexttospeech_torch.audio.stft import STFTConfig, windowed_frames
from neuraltexttospeech_torch.ops import mel_kernel

CONFIGS = {
    "default": dict(),
    "small": dict(filter_length=64, frame_length=64, frame_step=16, n_mel_channels=8),
}
TOL = dict(atol=1e-3, rtol=1e-4)  # the log-mel budget of tests/test_audio.py


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("n_fft", [64, 1024])
def test_dft_constants_give_the_rfft(n_fft):
    x = np.random.default_rng(0).standard_normal((5, n_fft))
    dr, di = mel_kernel._dft_constants(n_fft, n_fft // 2 + 1)
    spec = np.fft.rfft(x, axis=-1)
    np.testing.assert_allclose(x @ dr, spec.real, atol=1e-3)
    np.testing.assert_allclose(x @ di, spec.imag, atol=1e-3)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_device_constants_are_padded_with_zeros(name):
    cfg = STFTConfig(**CONFIGS[name])
    dr, di, basis = mel_kernel._device_constants(cfg, torch.device("cpu"))
    n_bins = cfg.filter_length // 2 + 1
    assert dr.shape == di.shape == (cfg.filter_length, dr.shape[1])
    assert dr.shape[1] % 64 == 0 and basis.shape[1] % 16 == 0
    assert basis.shape[0] == dr.shape[1]
    assert not dr[:, n_bins:].any() and not di[:, n_bins:].any()
    assert not basis[n_bins:].any() and not basis[:, cfg.n_mel_channels:].any()
    np.testing.assert_array_equal(basis[:n_bins, :cfg.n_mel_channels].numpy(), cfg.mel_basis())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("power", [0.5, 1.0, 2.0])
def test_cuda_kernel_matches_plain_twin(cuda_device, name, power):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = STFTConfig(**CONFIGS[name], magnitude_power=power)
    rng = np.random.default_rng(4)
    x = torch.as_tensor((rng.standard_normal((3, 30000)) * 0.2).astype(np.float32),
                        device=cuda_device)
    frames = windowed_frames(x, cfg.frame_length, cfg.frame_step,
                             cfg.filter_length).reshape(-1, cfg.filter_length).contiguous()
    before = mel_kernel.fused_frames_to_mel.launches
    got = mel_kernel.fused_frames_to_mel(frames, cfg)
    assert mel_kernel.fused_frames_to_mel.launches == before + 1
    torch.testing.assert_close(got, mel_kernel.frames_to_mel_reference(frames, cfg), **TOL)
    # a ragged frame count (not a multiple of the 32-frame tile) and one frame
    for n in (33, 1):
        torch.testing.assert_close(mel_kernel.fused_frames_to_mel(frames[:n].contiguous(), cfg),
                                   mel_kernel.frames_to_mel_reference(frames[:n], cfg), **TOL)


@pytest.mark.gpu
def test_cuda_entry_points_take_the_kernel(cuda_device):
    from neuraltexttospeech_torch.audio.stft import mel_spectrogram

    cfg = STFTConfig()
    x = torch.randn(2, 22050, device=cuda_device) * 0.2
    before = mel_kernel.fused_frames_to_mel.launches
    mel = mel_spectrogram(x, cfg)
    assert mel_kernel.fused_frames_to_mel.launches == before + 1
    frames = windowed_frames(x, 1024, 256, 1024).reshape(-1, 1024)
    torch.testing.assert_close(mel.reshape(-1, 80),
                               mel_kernel.frames_to_mel_reference(frames, cfg), **TOL)


@pytest.mark.gpu
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    cfg = STFTConfig()
    frames = torch.zeros(8, 1024, device=cuda_device)
    with pytest.raises(ValueError):
        mel_kernel.fused_frames_to_mel(frames.double(), cfg)
    with pytest.raises(ValueError):
        mel_kernel.fused_frames_to_mel(frames[:, :512], cfg)
    with pytest.raises(ValueError):
        mel_kernel.fused_frames_to_mel(torch.zeros(1024, 8, device=cuda_device).t(), cfg)
    with pytest.raises(ValueError):  # no instantiation for 40 mels
        mel_kernel.fused_frames_to_mel(frames, STFTConfig(n_mel_channels=40))
    assert mel_kernel.fused_frames_to_mel(frames[:0], cfg).shape == (0, 80)
