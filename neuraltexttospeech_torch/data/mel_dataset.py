"""HiFi-GAN / vocoder dataset: random fixed-size waveform crops (+ mels).

Counterpart of ``neuraltexttospeech_tpu/data/mel_dataset.py::VocoderDataset``
(:28-164): each item is a random ``segment_size``-sample crop (zero-padded if
the clip is shorter), drawn with numpy in the same order and from the same
seeds, so a seed gives the same crops as the JAX dataset. A batch holds
the crops, the generator-input mel (fmin..fmax) and the loss-target mel
(``fmax_for_loss``), computed on the host through the port's
``mel_spectrogram`` with HiFi-GAN's centered reflect padding; with
``audio_only=True`` only the crops (the GAN step computes both mels).

In fine-tuning mode (``fine_tuning_mel_dir``, ``mel_dataset.py:83-103,
143-151`` of the JAX package) the generator's input mel is an acoustic
model's ``<utt>_mel.npy``, cropped at a random frame, and the audio crop is
aligned to it; the loss mel is the audio crop's, through the fused log-mel
(``ops/mel_kernel.py``: its plain twin on these host tensors).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional

import numpy as np
import torch
from torch.nn import functional as F

from ..audio.stft import STFTConfig, mel_spectrogram
from ..ops.mel_kernel import fused_mel_spectrogram
from .filelist import load_filepaths_and_text, load_wav

__all__ = ["VocoderDataset"]


class VocoderDataset:
    def __init__(
        self,
        filelist_path,
        *,
        segment_size: int = 8192,
        n_fft: int = 1024,
        hop_size: int = 256,
        win_size: int = 1024,
        num_mels: int = 80,
        sampling_rate: int = 22050,
        fmin: float = 0.0,
        fmax: float = 8000.0,
        fmax_for_loss: Optional[float] = None,
        fine_tuning_mel_dir: Optional[str] = None,
        seed: int = 1234,
    ):
        self.fine_tuning_mel_dir = fine_tuning_mel_dir
        self.files = [f[0] for f in load_filepaths_and_text(filelist_path)]
        self.segment_size = segment_size
        self.hop_size = hop_size
        self.sampling_rate = sampling_rate
        self.rng = np.random.default_rng(seed)
        common = dict(filter_length=n_fft, frame_length=win_size, frame_step=hop_size,
                      n_mel_channels=num_mels, sampling_rate=sampling_rate, mel_fmin=fmin)
        self.mel_cfg = STFTConfig(mel_fmax=fmax, **common)
        self.mel_loss_cfg = STFTConfig(
            mel_fmax=fmax_for_loss if fmax_for_loss is not None else sampling_rate / 2.0,
            **common)

    def __len__(self):
        return len(self.files)

    def _segment(self, audio: np.ndarray) -> np.ndarray:
        """Random crop / zero-pad to segment_size (reference ``data.py:113-130``)."""
        if len(audio) >= self.segment_size:
            start = int(self.rng.integers(0, len(audio) - self.segment_size + 1))
            return audio[start: start + self.segment_size]
        return np.pad(audio, (0, self.segment_size - len(audio)))

    def __getitem__(self, index: int) -> np.ndarray:
        audio, _ = load_wav(self.files[index], self.sampling_rate)
        return self._segment(audio)

    def _fine_tuning_item(self, index: int):
        """(audio crop, mel crop): ``segment_size // hop`` frames of the
        acoustic model's mel from a random start (zero-padded when shorter),
        and the audio from that frame's first sample."""
        audio, _ = load_wav(self.files[index], self.sampling_rate)
        base = os.path.basename(self.files[index]).replace(".wav", "_mel.npy")
        mel = np.load(os.path.join(self.fine_tuning_mel_dir, base))
        frames = self.segment_size // self.hop_size
        if mel.shape[0] >= frames:
            start = int(self.rng.integers(0, mel.shape[0] - frames + 1))
        else:
            mel = np.pad(mel, ((0, frames - mel.shape[0]), (0, 0)))
            start = 0
        a0 = start * self.hop_size
        seg = audio[a0: a0 + self.segment_size]
        if len(seg) < self.segment_size:
            seg = np.pad(seg, (0, self.segment_size - len(seg)))
        return seg.astype(np.float32), mel[start: start + frames].astype(np.float32)

    def _loss_mels(self, audio_b: np.ndarray) -> np.ndarray:
        """The loss-target mels of a batch of crops, by the fused log-mel."""
        pad = (self.mel_loss_cfg.filter_length - self.hop_size) // 2
        x = F.pad(torch.as_tensor(audio_b, dtype=torch.float32)[:, None], (pad, pad),
                  mode="reflect")[:, 0]
        return fused_mel_spectrogram(x, self.mel_loss_cfg).numpy()

    def _mels(self, audio_b: np.ndarray):
        """Host mels of a batch of crops: generator input and loss target."""
        pad = (self.mel_cfg.filter_length - self.hop_size) // 2
        x = torch.as_tensor(audio_b, dtype=torch.float32)
        padded = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
        return (mel_spectrogram(padded, self.mel_cfg).numpy(),
                mel_spectrogram(padded, self.mel_loss_cfg).numpy())

    def batch_indices(self, batch_size: int, *, seed: int = 0,
                      max_batches: Optional[int] = None):
        """The file indices of each batch of a shuffled epoch (the last,
        short batch dropped); draws no crop."""
        order = np.arange(len(self))
        rng = np.random.default_rng(seed)
        rng.shuffle(order)
        if len(order) < batch_size:
            # corpus smaller than the batch: sample files with replacement
            n = max_batches if max_batches is not None else 1
            idxs = [rng.integers(0, len(order), size=batch_size) for _ in range(n)]
        else:
            idxs = [order[i: i + batch_size]
                    for i in range(0, len(order) - batch_size + 1, batch_size)]
        return idxs if max_batches is None else idxs[:max_batches]

    def batches(self, batch_size: int, *, seed: int = 0, max_batches: Optional[int] = None,
                audio_only: bool = False, skip: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Yield ``{"audio": [B, S, 1]}`` (and ``mel``, ``mel_loss`` unless
        ``audio_only``; always in fine-tuning mode) as float32 numpy arrays.
        ``skip`` passes over the first batches of the epoch without drawing
        their crops (resume)."""
        for idxs in self.batch_indices(batch_size, seed=seed, max_batches=max_batches)[skip:]:
            if self.fine_tuning_mel_dir is not None:
                pairs = [self._fine_tuning_item(j) for j in idxs]
                audio = np.stack([p[0] for p in pairs])
                yield {"audio": audio[..., None], "mel": np.stack([p[1] for p in pairs]),
                       "mel_loss": self._loss_mels(audio)}
                continue
            audio = np.stack([self[j] for j in idxs]).astype(np.float32)
            batch = {"audio": audio[..., None]}
            if not audio_only:
                batch["mel"], batch["mel_loss"] = self._mels(audio)
            yield batch
