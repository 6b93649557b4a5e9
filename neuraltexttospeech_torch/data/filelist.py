"""Filelist parsing and WAV IO.

Reference: ``FastPitch_TF/data_function.py:27-46`` (pipe-separated
``wav|[pitch|]text[|speaker]`` lists, ``tf.audio.decode_wav`` loading).
WAV reading here uses scipy (int16 PCM → float32 / max_wav_value), matching
the reference's scaling convention (``HiFiGAN_TF/mel_dataset.py`` scipy
read emulation).
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
from scipy.io import wavfile

__all__ = ["load_filepaths_and_text", "load_wav", "save_wav", "MAX_WAV_VALUE"]

MAX_WAV_VALUE = 32768.0


def load_filepaths_and_text(filelist, split: str = "|") -> List[List[str]]:
    if isinstance(filelist, str):
        with open(filelist, encoding="utf-8") as f:
            return [line.strip().split(split) for line in f if line.strip()]
    return filelist


def load_wav(full_path: str, target_sr: int | None = None) -> Tuple[np.ndarray, int]:
    """Load a wav as float32 in [-1, 1). Returns (audio [T], sample_rate)."""
    sr, data = wavfile.read(full_path)
    if target_sr is not None and sr != target_sr:
        raise ValueError(f"{full_path}: {sr} SR doesn't match target {target_sr} SR")
    if data.ndim > 1:
        data = data[:, 0]
    if data.dtype == np.int16:
        audio = data.astype(np.float32) / MAX_WAV_VALUE
    elif data.dtype == np.int32:
        audio = data.astype(np.float32) / 2147483648.0
    elif data.dtype in (np.float32, np.float64):
        audio = data.astype(np.float32)
    else:
        raise ValueError(f"unsupported wav dtype {data.dtype}")
    return audio, sr


def save_wav(path: str, audio: np.ndarray, sr: int = 22050):
    """Write float32 [-1, 1] audio as 16-bit PCM (reference
    ``DiffWave_TF/inference.py:194-200`` uses tf.audio.encode_wav)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    pcm = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
    wavfile.write(path, sr, (pcm * 32767.0).astype(np.int16))
