"""FastSpeech 2 preprocessing: MFA TextGrids → duration/pitch/energy/mel.

Counterpart of ``neuraltexttospeech_tpu/data/fs2_preprocess.py`` (:35-219),
with the same on-disk contract: per utterance, align the MFA phone
intervals to mel frames, take the frame pitch (``data/pitch.py::yin_pitch``,
on the host CPU) and the frame energy (the norm of each log-mel row), average
both over each phone's frames, then z-normalize them with the corpus
statistics written to ``stats.json`` (flat keys and the reference's
``[min, max, mean, std]`` lists). The log-mel goes through the port's
``STFT`` on ``device``: kernel B1 on the card, one launch per wav.

Outputs under ``out_dir``: ``<utt>_{duration,pitch,energy,mel}.npy``,
``train.txt``/``val.txt`` (split with ``default_rng(1234)``, as in JAX) and
``stats.json``.
"""

from __future__ import annotations

import json
import pathlib
from typing import List, Optional, Tuple

import numpy as np

from ..audio.stft import STFT
from .filelist import load_wav
from .pitch import yin_pitch
from .textgrid import parse_textgrid

__all__ = ["FS2Preprocessor", "SIL_PHONES"]

SIL_PHONES = {"sil", "sp", "spn", ""}


class FS2Preprocessor:
    def __init__(self, raw_path: str, textgrid_path: str, out_dir: str, *,
                 sampling_rate: int = 22050, hop_length: int = 256, filter_length: int = 1024,
                 win_length: int = 1024, n_mel_channels: int = 80, mel_fmin: float = 0.0,
                 mel_fmax: float = 8000.0, val_size: int = 512,
                 pitch_normalization: bool = True, energy_normalization: bool = True,
                 device=None):
        """``device`` computes the log-mels (default: the card)."""
        self.raw_path = pathlib.Path(raw_path)
        self.textgrid_path = pathlib.Path(textgrid_path)
        self.out_dir = pathlib.Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.sampling_rate = sampling_rate
        self.hop_length = hop_length
        self.val_size = val_size
        self.pitch_normalization = pitch_normalization
        self.energy_normalization = energy_normalization
        self.stft = STFT(filter_length=filter_length, frame_length=win_length,
                         frame_step=hop_length, n_mel_channels=n_mel_channels,
                         sampling_rate=sampling_rate, mel_fmin=mel_fmin, mel_fmax=mel_fmax,
                         device=device)

    def get_alignment(self, intervals) -> Tuple[List[str], List[int], float, float]:
        """Phone labels and per-phone frame durations, leading and trailing
        silence stripped (reference ``preprocessor.py:get_alignment``)."""
        phones, durations = [], []
        start_time = end_time = 0.0
        end_idx = 0
        sr, hop = self.sampling_rate, self.hop_length
        for (s, e, p) in intervals:
            if not phones:
                if p in SIL_PHONES:
                    continue
                start_time = s
            phones.append(p)
            durations.append(int(np.round(e * sr / hop) - np.round(s * sr / hop)))
            if p not in SIL_PHONES:
                end_time = e
                end_idx = len(phones)
        return phones[:end_idx], durations[:end_idx], start_time, end_time

    def process_utterance(self, utt_id: str, text: str, wav_path: str,
                          tg_path: str) -> Optional[dict]:
        tiers = parse_textgrid(tg_path)
        if "phones" not in tiers:
            return None
        phones, durations, start, end = self.get_alignment(tiers["phones"])
        if not phones or end <= start:
            return None
        audio, _ = load_wav(wav_path, self.sampling_rate)
        a = audio[int(self.sampling_rate * start):int(self.sampling_rate * end)].astype(np.float32)

        mel = self.stft.mel_spectrogram(a).cpu().numpy().astype(np.float32)
        n_frames = min(mel.shape[0], int(np.sum(durations)))
        mel = mel[:n_frames]
        pitch = yin_pitch(a, sr=self.sampling_rate, hop_length=self.hop_length,
                          n_frames=n_frames).numpy().astype(np.float32)
        energy = np.linalg.norm(mel, axis=1)

        # pitch interpolated through unvoiced frames, then pitch and energy
        # averaged over each phone's frames (phoneme_level features,
        # reference ``preprocessor.py:225-248``)
        voiced_ids = np.where(pitch > 0)[0]
        if len(voiced_ids):
            pitch = np.interp(np.arange(len(pitch)), voiced_ids,
                              pitch[voiced_ids]).astype(np.float32)
        durations = np.asarray(durations, np.int64)
        cum = np.minimum(np.cumsum(durations), n_frames)  # durations clipped to the frames
        starts = np.concatenate([[0], cum[:-1]])
        ph_pitch = np.zeros(len(durations), np.float32)
        ph_energy = np.zeros(len(durations), np.float32)
        for i, (s, e) in enumerate(zip(starts, cum)):
            if e > s:
                ph_pitch[i] = pitch[s:e].mean()
                ph_energy[i] = energy[s:e].mean()
        durations = (cum - starts).astype(np.int64)

        np.save(self.out_dir / f"{utt_id}_duration.npy", durations)
        np.save(self.out_dir / f"{utt_id}_pitch.npy", ph_pitch)
        np.save(self.out_dir / f"{utt_id}_energy.npy", ph_energy)
        np.save(self.out_dir / f"{utt_id}_mel.npy", mel)
        return {"id": utt_id, "text": text, "phones": "{" + " ".join(phones) + "}",
                "pitch": ph_pitch, "energy": ph_energy, "n_frames": n_frames}

    @staticmethod
    def remove_outlier(values: np.ndarray) -> np.ndarray:
        """IQR filter for the corpus statistics (reference
        ``preprocessor.py:remove_outlier``: strict 1.5·IQR fences)."""
        values = np.asarray(values)
        if values.size == 0:
            return values
        p25, p75 = np.percentile(values, 25), np.percentile(values, 75)
        lower, upper = p25 - 1.5 * (p75 - p25), p75 + 1.5 * (p75 - p25)
        return values[np.logical_and(values > lower, values < upper)]

    def normalize(self, suffix: str, mean: float, std: float) -> Tuple[float, float]:
        """Z-normalize the saved features in place (every value, zeros
        included); returns (min, max) over the normalized corpus."""
        vmin, vmax = np.inf, -np.inf
        for f in self.out_dir.glob(f"*_{suffix}.npy"):
            x = (np.load(f) - mean) / std
            vmin = min(vmin, float(x.min(initial=np.inf)))
            vmax = max(vmax, float(x.max(initial=-np.inf)))
            np.save(f, x)
        return vmin, vmax

    def build_from_path(self, metadata: List[Tuple[str, str]], verbose: bool = True) -> dict:
        """metadata: [(utt_id, text)]. Reads ``<raw>/<utt>.wav`` and
        ``<textgrid>/<utt>.TextGrid``; returns the statistics."""
        entries, pitch_all, energy_all = [], [], []
        n_total_frames = 0
        for i, (utt_id, text) in enumerate(metadata):
            wav = self.raw_path / f"{utt_id}.wav"
            tg = self.textgrid_path / f"{utt_id}.TextGrid"
            if not wav.exists() or not tg.exists():
                continue
            r = self.process_utterance(utt_id, text, str(wav), str(tg))
            if r is None:
                continue
            entries.append(f"{r['id']}|{r['phones']}|{r['text']}")
            # pooled mean/std over the IQR-filtered values (reference
            # ``preprocessor.py:103-110``)
            pitch_all.append(self.remove_outlier(r["pitch"]))
            energy_all.append(self.remove_outlier(r["energy"]))
            n_total_frames += r["n_frames"]
            if verbose and (i + 1) % 200 == 0:
                print(f"processed {i + 1}/{len(metadata)}")

        pitch_cat = np.concatenate(pitch_all) if pitch_all else np.zeros(1, np.float32)
        energy_cat = np.concatenate(energy_all) if energy_all else np.zeros(1, np.float32)
        stats = {"pitch_mean": float(pitch_cat.mean()),
                 "pitch_std": float(pitch_cat.std() + 1e-9),
                 "energy_mean": float(energy_cat.mean()),
                 "energy_std": float(energy_cat.std() + 1e-9),
                 "n_frames": int(n_total_frames)}
        if self.pitch_normalization:
            stats["pitch_min"], stats["pitch_max"] = self.normalize(
                "pitch", stats["pitch_mean"], stats["pitch_std"])
        if self.energy_normalization:
            stats["energy_min"], stats["energy_max"] = self.normalize(
                "energy", stats["energy_mean"], stats["energy_std"])
        # the reference's format ("pitch"/"energy": [min, max, mean, std],
        # ``preprocessor.py:136-153``) beside the flat keys
        for k in ("pitch", "energy"):
            if f"{k}_min" in stats:
                stats[k] = [stats[f"{k}_min"], stats[f"{k}_max"], stats[f"{k}_mean"],
                            stats[f"{k}_std"]]
        with open(self.out_dir / "stats.json", "w") as f:
            json.dump(stats, f, indent=2)

        rng = np.random.default_rng(1234)
        rng.shuffle(entries)
        (self.out_dir / "train.txt").write_text("\n".join(entries[self.val_size:]) + "\n")
        (self.out_dir / "val.txt").write_text("\n".join(entries[:self.val_size]) + "\n")
        return stats
