"""Mel filterbank and window construction (host-side, NumPy).

Reimplements ``tf.signal.linear_to_mel_weight_matrix`` semantics from its
documented algorithm (HTK mel scale, DC bin zeroed, triangular bands computed
in mel space) so mel spectrograms match the reference pipeline
(``FastPitch_TF/common/audio_processing_tf.py:63-69``) within float tolerance.
Built once on the host; the result is a constant copied to the device.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = [
    "hertz_to_mel",
    "mel_to_hertz",
    "linear_to_mel_weight_matrix",
    "hann_window",
]


def hertz_to_mel(frequencies_hertz):
    """HTK mel scale used by tf.signal: m = 1127 * ln(1 + f / 700)."""
    return 1127.0 * np.log1p(np.asarray(frequencies_hertz, dtype=np.float64) / 700.0)


def mel_to_hertz(mels):
    return 700.0 * np.expm1(np.asarray(mels, dtype=np.float64) / 1127.0)


@functools.lru_cache(maxsize=32)
def linear_to_mel_weight_matrix(
    num_mel_bins: int = 80,
    num_spectrogram_bins: int = 513,
    sample_rate: float = 22050.0,
    lower_edge_hertz: float = 0.0,
    upper_edge_hertz: float = 8000.0,
    dtype=np.float32,
) -> np.ndarray:
    """[num_spectrogram_bins, num_mel_bins] triangular mel filterbank.

    Matches tf.signal.linear_to_mel_weight_matrix: the DC FFT bin is excluded
    from band computation and zeroed, band edges are linearly spaced in mel
    space between the lower/upper edges, and each filter is the intersection
    of the rising and falling slopes clamped at zero.
    """
    if num_mel_bins <= 0:
        raise ValueError("num_mel_bins must be positive")
    if lower_edge_hertz >= upper_edge_hertz:
        raise ValueError("lower_edge_hertz must be < upper_edge_hertz")

    # Compute in float32 like tf.signal does, so the weights match bit-close.
    def h2m(f):
        return np.float32(1127.0) * np.log1p(
            np.asarray(f, dtype=np.float32) / np.float32(700.0)
        )

    bands_to_zero = 1  # tf.signal zeroes the DC bin
    nyquist_hertz = sample_rate / 2.0
    linear_frequencies = np.linspace(
        0.0, nyquist_hertz, num_spectrogram_bins, dtype=np.float32
    )[bands_to_zero:]
    spectrogram_bins_mel = h2m(linear_frequencies)[:, np.newaxis]

    band_edges_mel = np.linspace(
        h2m(lower_edge_hertz),
        h2m(upper_edge_hertz),
        num_mel_bins + 2,
        dtype=np.float32,
    )
    lower_edge_mel = band_edges_mel[np.newaxis, 0:-2]
    center_mel = band_edges_mel[np.newaxis, 1:-1]
    upper_edge_mel = band_edges_mel[np.newaxis, 2:]

    lower_slopes = (spectrogram_bins_mel - lower_edge_mel) / (
        center_mel - lower_edge_mel
    )
    upper_slopes = (upper_edge_mel - spectrogram_bins_mel) / (
        upper_edge_mel - center_mel
    )
    mel_weights = np.maximum(0.0, np.minimum(lower_slopes, upper_slopes))

    # Re-add the zeroed DC row.
    mel_weights = np.pad(mel_weights, [[bands_to_zero, 0], [0, 0]])
    return mel_weights.astype(dtype)


@functools.lru_cache(maxsize=16)
def hann_window(window_length: int, periodic: bool = True, dtype=np.float32) -> np.ndarray:
    """Hann window matching tf.signal.hann_window (periodic by default)."""
    if window_length <= 1:
        return np.ones((window_length,), dtype=dtype)
    denom = window_length if periodic else window_length - 1
    n = np.arange(window_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / denom)).astype(dtype)
