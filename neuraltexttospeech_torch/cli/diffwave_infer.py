"""DiffWave inference CLI: mel ``.npy`` → wav by the reverse process.

Port of ``diffwave/inference.py``: each ``*.npy`` mel ([F, n_mels] or
[1, F, n_mels]) in the input directory is sampled to a wav with the
checkpoint's own config, by the 50-step schedule or, with ``--fast``, the
6-step aligned one. ``--chunked`` samples crop-size slices of the mel one
after another, the last one zero-padded and its audio trimmed (reference
``predict_by_slice``). ``--amp`` computes in bf16 (weights stay f32).

Each file's randomness comes from a generator seeded from ``(--seed, file
index)``, each slice's from ``(--seed, file index, first frame)``; the JAX
CLI folds the same numbers into its key, so the two draw other noise.

Usage:
  python -m neuraltexttospeech_torch.cli.diffwave_infer --checkpoint CKPT_DIR \\
      -i mels_dir -o out/wavs [--fast] [--chunked] [--device cpu]
"""

from __future__ import annotations

import argparse
import pathlib
from typing import Optional

import numpy as np
import torch

from ..data.filelist import save_wav
from ..models.diffwave import DiffWave, reverse_sample
from ..models.registry import load_checkpoint
from ..nn.precision import compute_dtype
from ..utils.device import resolve_device
from ..utils.generators import seeded_generator


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True, help="port DiffWave checkpoint dir")
    p.add_argument("-i", "--input", required=True, help="dir of mel .npy files")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--fast", action="store_true", help="fast sampling (6 steps)")
    p.add_argument("--chunked", action="store_true",
                   help="synthesize in crop-size slices (reference predict_by_slice)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--amp", action="store_true",
                   help="bf16 compute (checkpoint weights stay f32)")
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    return p.parse_args(argv)


def synthesize(model: DiffWave, mel: np.ndarray, *, device: torch.device, seed: int = 0,
               index: int = 0, fast: bool = False, chunked: bool = False,
               dtype: Optional[torch.dtype] = None) -> np.ndarray:
    """One mel [F, n_mels] or [1, F, n_mels] → f32 audio [1, F·hop]."""
    config = model.config
    if mel.ndim == 2:
        mel = mel[None]
    mel = torch.as_tensor(np.asarray(mel, np.float32), device=device)

    def sample(m, generator):
        with compute_dtype(dtype):
            return reverse_sample(model, m, fast_sampling=fast, generator=generator)

    if not chunked:
        return sample(mel, seeded_generator(device, seed, index)).cpu().numpy()
    crop, chunks = config.crop_mel_frames, []
    for s in range(0, mel.shape[1], crop):
        piece = mel[:, s:s + crop]
        if piece.shape[1] < crop:
            piece = torch.nn.functional.pad(piece, (0, 0, 0, crop - piece.shape[1]))
        chunks.append(sample(piece, seeded_generator(device, seed, index, s)).cpu().numpy())
    return np.concatenate(chunks, axis=1)[:, :mel.shape[1] * config.hop_length]


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    model, config = load_checkpoint(args.checkpoint, "DiffWave", device)
    out_dir = pathlib.Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    for i, f in enumerate(sorted(pathlib.Path(args.input).glob("*.npy"))):
        audio = synthesize(model, np.load(f), device=device, seed=args.seed, index=i,
                           fast=args.fast, chunked=args.chunked,
                           dtype=torch.bfloat16 if args.amp else None)
        save_wav(str(out_dir / f"{f.stem}.wav"), audio[0], config.sample_rate)
        print(f"{f.stem}: {audio.shape[1] / config.sample_rate:.2f}s")


if __name__ == "__main__":
    main()
