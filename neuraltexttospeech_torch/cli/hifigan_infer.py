"""HiFi-GAN inference CLI: mel ``.npy`` (or wav copy-synthesis) → wav.

Port of ``hifigan/inference.py``. The input is a directory of ``*.npy``
mels, or a wav filelist for copy-synthesis: each wav is reflect-padded by
``(n_fft - hop) // 2`` and turned into a log-mel by ``audio.stft.mel_spectrogram``,
which on the card is the fused CUDA kernel of ``ops/mel_kernel.py``.

Usage:
  python -m neuraltexttospeech_torch.cli.hifigan_infer --checkpoint CKPT_DIR \
      -i mels_dir_or_filelist -o out/wavs [--device cpu]

``CKPT_DIR`` is a port checkpoint (``model.pt`` + ``model_config.json``, see
``tools/jax_to_torch_checkpoint.py``).
"""

from __future__ import annotations

import argparse
import pathlib
from typing import Optional

import numpy as np
import torch
from torch.nn import functional as F

from ..audio.stft import STFTConfig, mel_spectrogram
from ..data.filelist import load_filepaths_and_text, load_wav, save_wav
from ..models.hifigan import HiFiGANConfig
from ..models.registry import load_checkpoint
from ..nn.precision import compute_dtype
from ..utils.device import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--config", default=None, choices=("v1", "v2", "v3"),
                   help="generator config to build instead of the checkpoint's "
                        "own model_config.json")
    p.add_argument("-i", "--input", required=True,
                   help="dir of *_mel.npy / *.npy mels, or a wav filelist "
                        "for copy-synthesis")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--amp", action="store_true",
                   help="bf16 compute for the generator (weights stay f32)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain path)")
    return p.parse_args(argv)


def load_generator(path, device: torch.device, config_spec: str | None = None):
    """(Generator, HiFiGANConfig) from a port checkpoint, on ``device``."""
    config = getattr(HiFiGANConfig, config_spec)() if config_spec else None
    return load_checkpoint(path, "HiFiGAN", device, config=config)


def stft_config(config: HiFiGANConfig) -> STFTConfig:
    return STFTConfig(
        filter_length=config.n_fft, frame_length=config.win_size,
        frame_step=config.hop_size, n_mel_channels=config.num_mels,
        sampling_rate=config.sampling_rate, mel_fmin=config.fmin,
        mel_fmax=config.fmax)


def wav_to_mel(audio: np.ndarray, config: HiFiGANConfig,
               device: torch.device) -> torch.Tensor:
    """Copy-synthesis input: reflect pad by ``(n_fft - hop) // 2``, then the
    log-mel [n_frames, num_mels] on ``device``."""
    pad = (config.n_fft - config.hop_size) // 2
    x = torch.as_tensor(audio, dtype=torch.float32, device=device)
    x = F.pad(x.view(1, 1, -1), (pad, pad), mode="reflect").view(-1)
    return mel_spectrogram(x, stft_config(config))


def iter_mels(input_path, config: HiFiGANConfig, device: torch.device):
    """Yield ``(name, mel [T, num_mels] on device)``."""
    path = pathlib.Path(input_path)
    if path.is_dir():
        for f in sorted(path.glob("*.npy")):
            yield f.stem, torch.as_tensor(np.load(f), dtype=torch.float32, device=device)
    else:
        for fields in load_filepaths_and_text(str(input_path)):
            audio, _ = load_wav(fields[0], config.sampling_rate)
            yield pathlib.Path(fields[0]).stem, wav_to_mel(audio, config, device)


def vocode(generator, mel: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """mel [B, T, num_mels] → f32 audio [B, T·hop]; the generator computes in
    ``dtype`` (``nn/precision.py``; None: f32)."""
    with torch.inference_mode(), compute_dtype(dtype):
        return generator(mel)[..., 0].float()


def vocode_replicas(replicas, generators, mels, frames: int,
                    dtype: Optional[torch.dtype] = None):
    """The serving CLIs' last stage over ``utils/serving.py::Replicas``: each
    replica's mels ``[b, T, num_mels]`` to host f32 numpy and, with
    ``generators`` (one a replica), vocoded at their first ``frames`` frames,
    the vocoder bucket the caller took over the whole batch. Returns the
    batch's ``(mel [B, T, num_mels], audio [B, frames·hop] or None)``, rows in
    replica order."""
    def run(i, mel):
        audio = None
        if generators is not None:
            # a batch whose utterances all got 0 frames has nothing to vocode
            audio = (vocode(generators[i], mel[:, :frames], dtype).cpu().numpy() if frames
                     else np.zeros((len(mel), 0), np.float32))
        return mel.cpu().numpy(), audio

    mel, audio = zip(*replicas.map(run, mels))
    return np.concatenate(mel), None if generators is None else np.concatenate(audio)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    gen, config = load_generator(args.checkpoint, device, args.config)
    out_dir = pathlib.Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    for name, mel in iter_mels(args.input, config, device):
        audio = vocode(gen, mel[None], torch.bfloat16 if args.amp else None)[0].cpu().numpy()
        save_wav(str(out_dir / f"{name}.wav"), audio, config.sampling_rate)
        print(f"{name}: {len(audio) / config.sampling_rate:.2f}s")


if __name__ == "__main__":
    main()
