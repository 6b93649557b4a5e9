"""The QuartzNet ASR's batches: log-mels of a ``wav|text`` filelist and
their character labels.

Counterpart of the data half of JAX's ``talknet/train.py::_train_asr``
(:64-94): each epoch's order is a numpy shuffle seeded with ``seed +
epoch``, batches hold whole utterances (the last short one dropped), their
log-mels are zero-padded to a multiple of 64 frames and their labels
(``StringMap``, blank 0) to a multiple of 16, and the transcripts ride along
for the WER.

The log-mels are computed on ``device`` (``audio/stft.py``, the default
STFT: n_fft 1024, hop 256, 80 mels up to 8 kHz), one call per utterance:
on a CUDA device that is one launch of kernel B1 (``ops/mel_kernel.py``)
per utterance, as the JAX CLI's ``STFT.mel_spectrogram`` runs the Pallas
kernel once per utterance on the TPU. The batch's ``mel`` is a tensor on
``device``; the other arrays are numpy.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch
from torch.nn import functional as F

from ..audio.stft import STFTConfig, mel_spectrogram
from ..models.talknet import StringMap
from .dataset import pad_to, round_up
from .filelist import load_filepaths_and_text, load_wav

__all__ = ["ASRDataset"]

VOCAB = StringMap()
STFT = STFTConfig()


class ASRDataset:
    def __init__(self, filelist, device=None):
        self.entries = load_filepaths_and_text(filelist)
        self.device = torch.device("cpu" if device is None else device)

    def __len__(self):
        return len(self.entries)

    def item(self, i: int):
        """(log-mel [T, n_mel] on the device, labels int32, transcript)."""
        wav, text = self.entries[i][0], self.entries[i][-1]
        audio, _ = load_wav(wav, STFT.sampling_rate)
        mel = mel_spectrogram(torch.as_tensor(audio, device=self.device), STFT)
        return mel, np.asarray(VOCAB.encode(text), np.int32), text

    def batches(self, batch_size: int, seed: int = 0, max_batches: Optional[int] = None,
                skip: int = 0) -> Iterator[Dict]:
        """The epoch's batches: ``mel`` [B, T, n_mel] (T a multiple of 64),
        ``mel_lens``, ``labels`` [B, L] (L a multiple of 16), ``label_lens``
        and ``texts``; ``skip`` leaves out the first batches of the order (a
        resumed epoch)."""
        order = np.arange(len(self.entries))
        np.random.default_rng(seed).shuffle(order)
        starts = list(range(0, len(order) - batch_size + 1, batch_size))
        if max_batches is not None:
            starts = starts[:max_batches]
        for s in starts[skip:]:
            items = [self.item(j) for j in order[s:s + batch_size]]
            T = round_up(max(m.shape[0] for m, _, _ in items), 64)
            L = round_up(max(len(l) for _, l, _ in items), 16)
            yield {"mel": torch.stack([F.pad(m, (0, 0, 0, T - m.shape[0])) for m, _, _ in items]),
                   "mel_lens": np.asarray([m.shape[0] for m, _, _ in items], np.int32),
                   "labels": np.stack([pad_to(l, L) for _, l, _ in items]),
                   "label_lens": np.asarray([len(l) for _, l, _ in items], np.int32),
                   "texts": [t for _, _, t in items]}
