"""STFT / mel-spectrogram front-end."""

from .mel import hann_window, linear_to_mel_weight_matrix
from .stft import STFT, STFTConfig, mel_spectrogram, num_frames

__all__ = ["STFT", "STFTConfig", "hann_window", "linear_to_mel_weight_matrix",
           "mel_spectrogram", "num_frames"]
