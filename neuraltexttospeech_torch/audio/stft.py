"""STFT → log-mel front-end (counterpart of ``neuraltexttospeech_tpu/audio/stft.py``).

Frames with a periodic Hann window (no end padding), rFFT magnitude,
``pow(mag, p)`` with ``p = 0.5`` (model pipelines) or ``p = 2`` (the
square-magnitude parity variant), mel filterbank matmul, and log dynamic-range
compression.

On a CUDA tensor :func:`mel_spectrogram` runs the whole chain in the
hand-written kernel of ``ops/mel_kernel.py``; on a CPU tensor it takes the
plain ``torch.fft.rfft`` path below.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .mel import hann_window, linear_to_mel_weight_matrix

__all__ = [
    "STFTConfig",
    "STFT",
    "dynamic_range_compression",
    "frame_signal",
    "stft_magnitude",
    "mel_spectrogram",
    "num_frames",
]


def dynamic_range_compression(x: torch.Tensor, C: float = 1.0,
                              clip_val: float = 1e-5) -> torch.Tensor:
    """log(clip(x, clip_val) * C)."""
    return torch.log(torch.clamp(x, min=clip_val) * C)


def num_frames(num_samples: int, frame_length: int, frame_step: int) -> int:
    """Frame count for pad_end=False framing (tf.signal.stft default)."""
    if num_samples < frame_length:
        return 0
    return 1 + (num_samples - frame_length) // frame_step


def frame_signal(x: torch.Tensor, frame_length: int, frame_step: int) -> torch.Tensor:
    """[..., T] -> [..., n_frames, frame_length] with pad_end=False (a view)."""
    if x.shape[-1] < frame_length:
        return x.new_zeros(x.shape[:-1] + (0, frame_length))
    return x.unfold(-1, frame_length, frame_step)


def windowed_frames(x: torch.Tensor, frame_length: int, frame_step: int,
                    fft_length: int) -> torch.Tensor:
    """Hann-windowed frames, zero-padded to ``fft_length``:
    [..., T] -> [..., n_frames, fft_length]."""
    window = torch.as_tensor(hann_window(frame_length), device=x.device)
    frames = frame_signal(x, frame_length, frame_step) * window
    if fft_length > frame_length:
        frames = torch.nn.functional.pad(frames, (0, fft_length - frame_length))
    return frames


def stft_magnitude(
    x: torch.Tensor,
    frame_length: int = 1024,
    frame_step: int = 256,
    fft_length: int = 1024,
) -> torch.Tensor:
    """|STFT(x)|: [..., T] -> [..., n_frames, fft_length // 2 + 1]."""
    frames = windowed_frames(x, frame_length, frame_step, fft_length)
    return torch.fft.rfft(frames, n=fft_length, dim=-1).abs()


@dataclasses.dataclass(frozen=True)
class STFTConfig:
    """Mirror of the reference STFT constructor arguments."""

    filter_length: int = 1024
    frame_length: int = 1024
    frame_step: int = 256
    n_mel_channels: int = 80
    sampling_rate: int = 22050
    mel_fmin: float = 0.0
    mel_fmax: float = 8000.0
    # Exponent applied to the magnitude before the mel matmul. The model
    # pipelines use 0.5; the AudioProcessing parity harness uses 2.0.
    magnitude_power: float = 0.5

    def mel_basis(self) -> np.ndarray:
        return linear_to_mel_weight_matrix(
            num_mel_bins=self.n_mel_channels,
            num_spectrogram_bins=self.filter_length // 2 + 1,
            sample_rate=float(self.sampling_rate),
            lower_edge_hertz=self.mel_fmin,
            upper_edge_hertz=self.mel_fmax,
        )

    def num_frames(self, num_samples: int) -> int:
        return num_frames(num_samples, self.frame_length, self.frame_step)


def mel_spectrogram(
    x: torch.Tensor,
    config: STFTConfig = STFTConfig(),
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """wav [..., T] -> log-mel [..., n_frames, n_mel_channels].

    ``use_kernel=None`` takes the fused CUDA kernel for a CUDA tensor and the
    plain rFFT path for a CPU tensor. ``use_kernel=True`` on a CPU tensor
    raises: the kernel runs only on the card.
    """
    if use_kernel is None:
        use_kernel = x.is_cuda
    if use_kernel:
        if not x.is_cuda:
            raise ValueError("the fused log-mel kernel needs a CUDA tensor")
        from ..ops.mel_kernel import fused_mel_spectrogram

        return fused_mel_spectrogram(x, config)
    magnitude = stft_magnitude(
        x, config.frame_length, config.frame_step, config.filter_length)
    basis = torch.as_tensor(config.mel_basis(), device=x.device)
    mel = torch.matmul(magnitude.pow(config.magnitude_power), basis)
    return dynamic_range_compression(mel)


class STFT:
    """Reference-API shim: ``STFT(...).mel_spectrogram(x)``.

    Accepts [T] or [B, T] (and, like the reference, squeezes a [1, T]
    input), as a numpy array or a tensor, and computes on ``device``.
    """

    def __init__(
        self,
        filter_length: int = 1024,
        frame_length: int = 1024,
        frame_step: int = 256,
        n_mel_channels: int = 80,
        sampling_rate: int = 22050,
        mel_fmin: float = 0.0,
        mel_fmax: Optional[float] = 8000.0,
        magnitude_power: float = 0.5,
        device=None,
    ):
        if mel_fmax is None:
            mel_fmax = sampling_rate / 2.0
        self.config = STFTConfig(
            filter_length=filter_length,
            frame_length=frame_length,
            frame_step=frame_step,
            n_mel_channels=n_mel_channels,
            sampling_rate=sampling_rate,
            mel_fmin=mel_fmin,
            mel_fmax=float(mel_fmax),
            magnitude_power=magnitude_power,
        )
        self.device = resolve_device(device)

    @property
    def mel_filterbank(self) -> np.ndarray:
        return self.config.mel_basis()

    def mel_spectrogram(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if x.ndim == 2 and x.shape[0] == 1:
            x = x.squeeze(0)
        return mel_spectrogram(x, self.config)
