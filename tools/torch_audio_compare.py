#!/usr/bin/env python3
"""Audio-library parity harness of the port, the oracle-diff method of the
reference's ``AudioProcessing/main.py`` (counterpart of
``tools/audio_compare.py``).

    python tools/torch_audio_compare.py --wav clip.wav      # a 22.05 kHz wav
    python tools/torch_audio_compare.py --seed 0            # a synthetic one

Loads the wav through every loader this machine has (``scipy.io.wavfile``,
the standard library's ``wave``, the port's ``data/filelist.py::load_wav``,
and ``soundfile`` or ``torchaudio`` where installed) and holds them to
scipy's samples; then pushes scipy's samples through three log-mel pipelines
(1024-point frames, hop 256, periodic Hann, 80 mels to 8 kHz, magnitude to
the 0.5, log with a 1e-5 floor):

- ``plain``: the port's plain path, ``audio/stft.py::mel_spectrogram`` on a
  CPU tensor (``torch.fft.rfft`` of the framed signal, the basis product);
- ``B1``: kernel B1 through ``ops/mel_kernel.py::fused_mel_spectrogram`` on
  the card (with ``--device cpu``, its plain twin);
- ``float64``: the same chain in float64 numpy, the oracle.

It prints L1 (mean |diff|) and L∞ (max |diff|) for every pair and fails
unless ``plain`` and ``B1`` are each within the JAX tool's 1e-3 of the
oracle. The JAX tool's oracle is ``tf.signal``; the card's machine has no
``tensorflow``, so the oracle here is float64 numpy, which the port's CPU
tests also hold ``tf.signal``'s counterpart in JAX to.

Without ``--wav`` the wav is 10 s of sines and noise from ``--seed``,
written as 16-bit PCM under ``--out``, so that the loaders read a real
file.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SR = 22050
BUDGET = 1e-3


def synthetic_wav(path: pathlib.Path, seconds: float, seed: int) -> pathlib.Path:
    """Four sines of random pitch and level plus noise, as 16-bit PCM."""
    from neuraltexttospeech_torch.data.filelist import save_wav

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    x = np.zeros(t.size)
    for _ in range(4):
        f, a, ph = rng.uniform(80, 4000), rng.uniform(0.05, 0.2), rng.uniform(0, 2 * np.pi)
        x += a * np.sin(2 * np.pi * f * t + ph)
    x += 0.01 * rng.standard_normal(t.size)
    save_wav(str(path), x.astype(np.float32), SR)
    return path


def load_backends(path: str):
    """``(sample rate, {loader: float32 samples})``: scipy, the standard
    library's ``wave`` and the port's loader always, ``soundfile`` and
    ``torchaudio`` where they import."""
    import wave

    from scipy.io import wavfile

    from neuraltexttospeech_torch.data.filelist import load_wav

    sr, data = wavfile.read(path)
    if data.dtype != np.int16:
        raise ValueError(f"{path}: expected 16-bit PCM, got {data.dtype}")
    out = {"scipy": (data if data.ndim == 1 else data[:, 0]).astype(np.float32) / 32768.0}
    with wave.open(path, "rb") as w:
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2").reshape(-1, w.getnchannels())
        out["wave"] = pcm[:, 0].astype(np.float32) / 32768.0
    out["port load_wav"] = load_wav(path)[0]
    try:
        import soundfile

        out["soundfile"] = soundfile.read(path, dtype="float32", always_2d=True)[0][:, 0]
    except ImportError:
        pass
    try:
        import torchaudio

        out["torchaudio"] = torchaudio.load(path)[0][0].numpy()
    except Exception:  # not installed, or no backend for wav files
        pass
    return sr, out


def mel_f64(x: np.ndarray, cfg) -> np.ndarray:
    """The log-mel in float64 numpy: frames, periodic Hann, rFFT magnitude
    to ``magnitude_power``, the mel basis, log with a 1e-5 floor."""
    from neuraltexttospeech_torch.audio.mel import hann_window

    frames = np.lib.stride_tricks.sliding_window_view(
        x.astype(np.float64), cfg.frame_length)[::cfg.frame_step]
    spec = np.abs(np.fft.rfft(frames * hann_window(cfg.frame_length, dtype=np.float64),
                              n=cfg.filter_length, axis=-1))
    return np.log(np.maximum(spec ** cfg.magnitude_power @ cfg.mel_basis().astype(np.float64),
                             1e-5))


def mel_pipelines(x: np.ndarray, sr: int, device) -> dict:
    """``{pipeline: log-mel [frames, 80]}`` of ``x`` (float32 samples)."""
    import torch

    from neuraltexttospeech_torch.audio.stft import STFTConfig, mel_spectrogram
    from neuraltexttospeech_torch.ops.mel_kernel import fused_mel_spectrogram

    cfg = STFTConfig(sampling_rate=sr)
    mels = {"plain": mel_spectrogram(torch.as_tensor(x), cfg, use_kernel=False).numpy(),
            "float64": mel_f64(x, cfg)}
    mel = fused_mel_spectrogram(torch.as_tensor(x, device=device), cfg)
    mels["B1"] = mel.cpu().numpy()
    return mels


def compare(wav: str, device="cuda") -> dict:
    """Run the harness on ``wav``: prints the loaders' and the pipelines'
    differences and returns ``{"loaders": {name: max|diff|}, "pairs": {(a,
    b): (L1, Linf)}, "frames": n}``; raises past :data:`BUDGET`."""
    from neuraltexttospeech_torch.utils.device import resolve_device

    device = resolve_device(device)
    sr, loads = load_backends(wav)
    base = loads["scipy"]
    print(f"{wav}: {len(base)} samples at {sr} Hz ({len(base) / sr:.2f} s); loaders: "
          f"{', '.join(sorted(loads))}")
    loaders = {}
    for name, arr in loads.items():
        if name != "scipy":
            n = min(len(arr), len(base))
            loaders[name] = float(np.abs(base[:n] - arr[:n]).max()) if len(arr) == len(base) \
                else float("inf")
            print(f"  wav {name} vs scipy: {len(arr)} samples, max |diff| {loaders[name]:.2e}")
    bad = {k: v for k, v in loaders.items() if v > 1.0 / 32768}
    if bad:
        raise RuntimeError(f"the loaders disagree with scipy: {bad}")

    mels = mel_pipelines(base, sr, device)
    names = ["plain", "B1", "float64"]
    where = f"on {device}" if device.type == "cuda" else "as its plain twin on the CPU"
    print(f"mel pipelines: {', '.join(names)} (B1 {where}), {mels['plain'].shape[0]} frames "
          f"x {mels['plain'].shape[1]} mels")
    pairs = {}
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            diff = np.abs(mels[a].astype(np.float64) - mels[b])
            pairs[a, b] = (float(diff.mean()), float(diff.max()))
            print(f"  {a} vs {b}: L1 {pairs[a, b][0]:.3e}  Linf {pairs[a, b][1]:.3e}")
    failed = []
    for ours in ("plain", "B1"):
        d = pairs[ours, "float64"][1]
        print(f"parity {ours} vs float64: {d:.3e} (budget {BUDGET:g}) "
              f"{'OK' if d <= BUDGET else 'FAIL'}")
        if not d <= BUDGET:
            failed.append(ours)
    if failed:
        raise RuntimeError(f"{', '.join(failed)} past the {BUDGET:g} budget against float64")
    return {"loaders": loaders, "pairs": pairs, "frames": mels["plain"].shape[0]}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--wav", default=None, help="a 16-bit PCM wav (default: a synthetic one)")
    p.add_argument("--seed", type=int, default=0, help="the synthetic wav's seed")
    p.add_argument("--out", default=str(ROOT / "out" / "audio_compare"),
                   help="where the synthetic wav is written")
    p.add_argument("--device", default="cuda", help="B1's device (default: cuda)")
    args = p.parse_args(argv)
    wav = args.wav or str(synthetic_wav(pathlib.Path(args.out) / f"synthetic_{args.seed}.wav",
                                        10.0, args.seed))
    return compare(wav, args.device)


if __name__ == "__main__":
    main()
