"""Fused wav→log-mel: the CUDA kernel for Hopper and its plain PyTorch twin.

Counterpart of ``neuraltexttospeech_tpu/ops/mel_kernel.py`` (the Pallas
kernel ``fused_frames_to_mel``, ``pallas_call`` at :163). The rFFT of a fixed
frame length is two products with constant DFT matrices, so the whole
pipeline is

    mag² = (frames @ Dr)² + (frames @ Di)²
    mel  = mag^p @ M
    out  = log(clip(mel, 1e-5))

``csrc/mel_kernel.cu`` does all of it on the card: one kernel forms the
spectrum and its partial mel sums per chunk of bins, a second adds them and
takes the log (the design and its bound are in that file).
:func:`frames_to_mel_reference` is the same chain in torch ops;
:func:`fused_frames_to_mel` takes it only for a CPU tensor. For a CUDA
tensor it launches the kernel or raises.

Forward only: the backward (for the HiFi-GAN mel loss) comes with training.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..audio.mel import linear_to_mel_weight_matrix
from ..audio.stft import STFTConfig, windowed_frames
from . import _build

__all__ = ["fused_mel_spectrogram", "fused_frames_to_mel",
           "frames_to_mel_reference", "SOURCE"]

SOURCE = "mel_kernel.cu"
_BIN_TILE = 64   # the kernel walks bins in chunks of 64 (kTileB)
_MEL_TILE = 16   # and splits mels over 16 thread groups
_MEL_WIDTHS = (16, 80)  # padded mel counts the kernel is instantiated for
_TAP_TILE = 16   # and taps in stages of 16 (kTileK)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@functools.lru_cache(maxsize=8)
def _dft_constants(fft_length: int, n_bins_padded: int):
    """Real/imag rDFT matrices [fft_length, n_bins_padded], zero-padded bins,
    built in float64 and cast to float32."""
    n_bins = fft_length // 2 + 1
    k = np.arange(fft_length, dtype=np.float64)[:, None]
    f = np.arange(n_bins, dtype=np.float64)[None, :]
    angle = -2.0 * np.pi * k * f / fft_length
    real = np.zeros((fft_length, n_bins_padded), dtype=np.float32)
    imag = np.zeros((fft_length, n_bins_padded), dtype=np.float32)
    real[:, :n_bins] = np.cos(angle)
    imag[:, :n_bins] = np.sin(angle)
    return real, imag


def _mel_basis(config: STFTConfig, n_bins_padded: int, n_mel_padded: int):
    n_bins = config.filter_length // 2 + 1
    basis = np.zeros((n_bins_padded, n_mel_padded), dtype=np.float32)
    basis[:n_bins, : config.n_mel_channels] = linear_to_mel_weight_matrix(
        num_mel_bins=config.n_mel_channels,
        num_spectrogram_bins=n_bins,
        sample_rate=float(config.sampling_rate),
        lower_edge_hertz=config.mel_fmin,
        upper_edge_hertz=config.mel_fmax,
    )
    return basis


def _power(mag_sq: torch.Tensor, power: float) -> torch.Tensor:
    """|X|^p from |X|²: p/2 == 1 takes no root, p/2 == 0.5 a sqrt."""
    half_p = power / 2.0
    if half_p == 1.0:
        return mag_sq
    if half_p == 0.5:
        return torch.sqrt(mag_sq)
    return torch.pow(mag_sq, half_p)


@functools.lru_cache(maxsize=8)
def _reference_constants(config: STFTConfig, device: torch.device):
    """Unpadded Dr, Di and M on ``device`` for the plain twin."""
    dr, di = _dft_constants(config.filter_length, config.filter_length // 2 + 1)
    return tuple(torch.as_tensor(a, device=device) for a in (dr, di, config.mel_basis()))


def frames_to_mel_reference(frames: torch.Tensor,
                            config: STFTConfig = STFTConfig()) -> torch.Tensor:
    """Plain twin of the kernel: windowed frames [N, fft_length] -> log-mel
    [N, n_mel_channels], as f32 ``torch.matmul``s against the same constants
    (unpadded)."""
    dr, di, basis = _reference_constants(config, frames.device)
    frames = frames.float()
    re = torch.matmul(frames, dr)
    im = torch.matmul(frames, di)
    mel = torch.matmul(_power(re * re + im * im, config.magnitude_power), basis)
    return torch.log(torch.clamp(mel, min=1e-5))


@functools.lru_cache(maxsize=8)
def _device_constants(config: STFTConfig, device: torch.device):
    """Padded Dr, Di and M for the kernel, uploaded once per (config, device)."""
    n_bins_p = _round_up(config.filter_length // 2 + 1, _BIN_TILE)
    n_mel_p = _round_up(config.n_mel_channels, _MEL_TILE)
    dr, di = _dft_constants(config.filter_length, n_bins_p)
    basis = _mel_basis(config, n_bins_p, n_mel_p)
    return tuple(torch.as_tensor(a, device=device) for a in (dr, di, basis))


@functools.lru_cache(maxsize=1)
def _launcher():
    fn = _build.load(SOURCE).logmel_frames
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def fused_frames_to_mel(frames: torch.Tensor,
                        config: STFTConfig = STFTConfig()) -> torch.Tensor:
    """Windowed frames [N, fft_length] -> log-mel [N, n_mel_channels].

    A CUDA tensor goes through the kernel, which takes contiguous float32
    frames and raises on anything else; a CPU tensor goes through
    :func:`frames_to_mel_reference`. ``fused_frames_to_mel.launches`` counts
    the kernel's launches.
    """
    if not frames.is_cuda:
        return frames_to_mel_reference(frames, config)
    fft_length = config.filter_length
    if frames.dtype != torch.float32 or frames.ndim != 2:
        raise ValueError(f"expected float32 frames [N, {fft_length}], got "
                         f"{frames.dtype} {tuple(frames.shape)}")
    if frames.shape[1] != fft_length or fft_length % _TAP_TILE:
        raise ValueError(f"frame length {frames.shape[1]} must equal "
                         f"filter_length {fft_length}, a multiple of {_TAP_TILE}")
    if not frames.is_contiguous() or frames.data_ptr() % 16:
        raise ValueError("frames must be contiguous and 16-byte aligned")
    if _round_up(config.n_mel_channels, _MEL_TILE) not in _MEL_WIDTHS:
        raise ValueError(f"the kernel takes 65..80 mel channels, or up to 16; "
                         f"got {config.n_mel_channels}")
    n = frames.shape[0]
    out = torch.empty((n, config.n_mel_channels), dtype=torch.float32,
                      device=frames.device)
    if n == 0:
        return out
    dr, di, basis = _device_constants(config, frames.device)
    partial = torch.empty((dr.shape[1] // _BIN_TILE, n, config.n_mel_channels),
                          dtype=torch.float32, device=frames.device)
    half_p = config.magnitude_power / 2.0
    power_mode = 1 if half_p == 1.0 else 2 if half_p == 0.5 else 0
    stream = torch.cuda.current_stream(frames.device).cuda_stream
    err = _launcher()(
        frames.data_ptr(), dr.data_ptr(), di.data_ptr(), basis.data_ptr(),
        partial.data_ptr(), out.data_ptr(), n, fft_length, dr.shape[1],
        config.n_mel_channels, basis.shape[1], power_mode, half_p,
        frames.device.index, stream)
    if err != 0:
        raise RuntimeError(f"log-mel kernel launch failed: CUDA error {err}")
    fused_frames_to_mel.launches += 1
    return out


fused_frames_to_mel.launches = 0


def fused_mel_spectrogram(x: torch.Tensor,
                          config: STFTConfig = STFTConfig()) -> torch.Tensor:
    """wav [..., T] -> log-mel [..., n_frames, n_mel] via the fused kernel."""
    frames = windowed_frames(x.float(), config.frame_length, config.frame_step,
                             config.filter_length)
    lead = frames.shape[:-1]
    mel = fused_frames_to_mel(frames.reshape(-1, config.filter_length).contiguous(),
                              config)
    return mel.reshape(lead + (config.n_mel_channels,))
