"""FastPitch dataset: filelists → cached features → bucketed batches.

Counterpart of ``neuraltexttospeech_tpu/data/dataset.py`` (:51-268), with the
same on-disk contract: a ``dataset_path`` cache directory of
``<utt>_mel.npy`` / ``<utt>_pitch.npy`` / ``<utt>_prior.npy`` beside the
pipe-separated filelists. Features are made by ``prepare()`` (or at first
access), never inside the training step:

- the log-mel through the port's ``STFT`` on ``device``: kernel B1 on the
  card, one launch per wav;
- pitch on the host CPU (``data/pitch.py``);
- energy, the L2 norm of the log-mel over channels;
- the beta-binomial prior with scipy (``data/prior.py``).

Batches are bucketed by mel length, padded to maxima rounded up to 16 (text)
and 32 (mel), and shuffled with numpy's generator, so the batch order for a
seed is JAX's.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..audio.stft import STFT
from ..text.processing import TextProcessing
from .filelist import MAX_WAV_VALUE, load_filepaths_and_text, load_wav
from .pitch import estimate_pitch
from .prior import beta_binomial_prior_distribution

__all__ = ["FastPitchDataset", "round_up", "pad_to"]

# LJSpeech pitch statistics (reference ``data_function.py:174``).
LJ_PITCH_MEAN = 214.72203
LJ_PITCH_STD = 65.72038


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def pad_to(arr: np.ndarray, target: int, axis: int = 0) -> np.ndarray:
    pad = target - arr.shape[axis]
    if pad <= 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths)


class FastPitchDataset:
    """Feature store and batch iterator for FastPitch training."""

    def __init__(
        self,
        dataset_path: str,
        filelist_path,
        text_cleaners: Sequence[str] = ("english_cleaners_v2",),
        n_mel_channels: int = 80,
        symbol_set: str = "english_basic",
        p_arpabet: float = 1.0,
        n_speakers: int = 1,
        pitch_mean: float = LJ_PITCH_MEAN,
        pitch_std: float = LJ_PITCH_STD,
        max_wav_value: float = MAX_WAV_VALUE,
        sampling_rate: int = 22050,
        filter_length: int = 1024,
        hop_length: int = 256,
        win_length: int = 1024,
        mel_fmin: float = 0.0,
        mel_fmax: float = 8000.0,
        prepend_space_to_text: bool = False,
        append_space_to_text: bool = False,
        load_pitch_from_disk: bool = False,
        with_pitch: bool = True,
        with_prior: bool = True,
        device=None,
    ):
        """``device`` computes the mels (default: the card)."""
        self.dataset_path = dataset_path
        os.makedirs(dataset_path, exist_ok=True)
        self.audiopaths_and_text = load_filepaths_and_text(filelist_path)
        self.n_speakers = n_speakers
        self.sampling_rate = sampling_rate
        self.hop_length = hop_length
        self.max_wav_value = max_wav_value
        self.load_pitch_from_disk = load_pitch_from_disk
        self.with_pitch = with_pitch
        self.with_prior = with_prior
        self.pitch_mean = pitch_mean
        self.pitch_std = pitch_std
        self.stft = STFT(filter_length=filter_length, frame_length=win_length,
                         frame_step=hop_length, n_mel_channels=n_mel_channels,
                         sampling_rate=sampling_rate, mel_fmin=mel_fmin, mel_fmax=mel_fmax,
                         device=device)
        self.tp = TextProcessing(symbol_set, list(text_cleaners), p_arpabet=p_arpabet)
        self.prepend_space_to_text = prepend_space_to_text
        self.append_space_to_text = append_space_to_text

        expected = 2 + int(load_pitch_from_disk) + (n_speakers > 1)
        if len(self.audiopaths_and_text[0]) < expected:
            raise ValueError(
                f"Expected {expected} columns in audiopaths file. "
                "The format is <mel_or_wav>|[<pitch>|]<text>[|<speaker_id>]")

    # ---------------------------------------------------------- features

    def _cache_path(self, audiopath: str, kind: str) -> str:
        base = os.path.basename(audiopath)
        return os.path.join(self.dataset_path, base.replace(".wav", f"_{kind}.npy"))

    def get_mel(self, audiopath: str) -> np.ndarray:
        """[T_mel, n_mel] log-mel, cached."""
        cached = self._cache_path(audiopath, "mel")
        if os.path.exists(cached):
            return np.load(cached)
        audio, _ = load_wav(audiopath, self.sampling_rate)
        mel = self.stft.mel_spectrogram(audio).cpu().numpy().astype(np.float32)
        np.save(cached, mel)
        return mel

    def get_text(self, text: str) -> np.ndarray:
        ids = self.tp.encode_text(text)
        space = [self.tp.encode_text("A A")[1]]
        if self.prepend_space_to_text:
            ids = space + ids
        if self.append_space_to_text:
            ids = ids + space
        return np.asarray(ids, np.int32)

    def get_pitch(self, index: int, mel_len: int) -> np.ndarray:
        """[1, T_mel] normalized f0, cached."""
        fields = self.audiopaths_and_text[index]
        audiopath = fields[0]
        if self.load_pitch_from_disk:
            pitch_path = fields[1]
            if pitch_path.endswith(".pt"):
                # the shipped LJSpeech |pitch| lists name torch ``.pt`` dumps;
                # the prepare step writes the same features as ``.npy``
                pitch_path = pitch_path[:-3] + ".npy"
            pitch = np.load(pitch_path).astype(np.float32)
            return pitch if pitch.ndim == 2 else pitch[None, :]
        cached = self._cache_path(audiopath, "pitch")
        if os.path.exists(cached):
            return np.load(cached)
        audio, _ = load_wav(audiopath, self.sampling_rate)
        pitch = estimate_pitch(audio, mel_len, sr=self.sampling_rate,
                               hop_length=self.hop_length, normalize_mean=self.pitch_mean,
                               normalize_std=self.pitch_std).astype(np.float32)
        np.save(cached, pitch)
        return pitch

    def get_prior(self, index: int, mel_len: int, text_len: int) -> np.ndarray:
        """[T_mel, T_text] beta-binomial prior, cached."""
        cached = self._cache_path(self.audiopaths_and_text[index][0], "prior")
        if os.path.exists(cached):
            prior = np.load(cached)
            if prior.shape == (mel_len, text_len):
                return prior
        prior = beta_binomial_prior_distribution(text_len, mel_len)
        np.save(cached, prior)
        return prior

    def __len__(self) -> int:
        return len(self.audiopaths_and_text)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        fields = self.audiopaths_and_text[index]
        audiopath = fields[0]
        speaker = int(fields[-1]) if self.n_speakers > 1 else 0
        text_field = fields[-2] if self.n_speakers > 1 else fields[-1]

        mel = self.get_mel(audiopath)
        text = self.get_text(text_field)
        item = {"text": text, "mel": mel, "speaker": np.int32(speaker),
                "audiopath": audiopath}
        if self.with_pitch:
            pitch = self.get_pitch(index, mel.shape[0])
            item["pitch"] = pitch[:, :mel.shape[0]]
            item["energy"] = np.linalg.norm(mel.astype(np.float32), ord=2, axis=1)
        if self.with_prior:
            item["attn_prior"] = self.get_prior(index, mel.shape[0], len(text))
        return item

    def prepare(self, verbose: bool = True):
        """Write every cache file (the ``prepare_dataset`` pass)."""
        for i in range(len(self)):
            self[i]
            if verbose and (i + 1) % 500 == 0:
                print(f"prepared {i + 1}/{len(self)}")

    # ---------------------------------------------------------- batching

    def lengths(self) -> List[int]:
        """Approximate mel lengths from the wav files' sizes (no decode)."""
        out = []
        for fields in self.audiopaths_and_text:
            n_samples = max(0, (os.path.getsize(fields[0]) - 44) // 2)
            out.append(self.stft.config.num_frames(n_samples))
        return out

    def batches(self, batch_size: int, *, shuffle: bool = True, seed: int = 0,
                text_pad_multiple: int = 16, mel_pad_multiple: int = 32,
                drop_last: bool = True, max_batches: Optional[int] = None,
                skip: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Bucketed, padded batches: items sorted by mel length, grouped,
        then the batch order shuffled. ``skip`` leaves out the first batches
        of the order (a resumed epoch)."""
        order = np.argsort(self.lengths(), kind="stable")
        batches = [order[i:i + batch_size]
                   for i in range(0, len(order) - (batch_size - 1 if drop_last else 0),
                                  batch_size)]
        if shuffle:
            np.random.default_rng(seed).shuffle(batches)
        if max_batches is not None:
            batches = batches[:max_batches]
        for idxs in batches[skip:]:
            yield self.collate([self[i] for i in idxs], text_pad_multiple, mel_pad_multiple)

    @staticmethod
    def collate(items: List[Dict[str, np.ndarray]], text_pad_multiple: int = 16,
                mel_pad_multiple: int = 32) -> Dict[str, np.ndarray]:
        """Pad a list of items to the rounded-up batch maxima."""
        T_text = round_up(max(len(it["text"]) for it in items), text_pad_multiple)
        T_mel = round_up(max(it["mel"].shape[0] for it in items), mel_pad_multiple)
        batch = {
            "text": np.stack([pad_to(it["text"], T_text) for it in items]),
            "input_lens": np.asarray([len(it["text"]) for it in items], np.int32),
            "mel": np.stack([pad_to(it["mel"], T_mel, 0) for it in items]),
            "mel_lens": np.asarray([it["mel"].shape[0] for it in items], np.int32),
            "speaker": np.asarray([it["speaker"] for it in items], np.int32),
        }
        if "pitch" in items[0]:
            batch["pitch"] = np.stack([pad_to(it["pitch"], T_mel, 1) for it in items])
            batch["energy"] = np.stack([pad_to(it["energy"], T_mel) for it in items])
        if "attn_prior" in items[0]:
            batch["attn_prior"] = np.stack([
                pad_to(pad_to(it["attn_prior"], T_mel, 0), T_text, 1) for it in items])
        return batch
