"""Flowtron inference CLI: sample ``z ~ N(0, σ²)`` and run the flows in
reverse (text → mel; → wav with ``--hifigan-checkpoint``).

Port of ``flowtron/inference.py``: each line through the ``english_basic``
front end (``english_cleaners``, no ARPAbet), in length-sorted batches padded
to 16-token buckets (``utils/serving.py::text_batches``), through
``Flowtron.infer`` over ``--n-frames`` frames of ``z`` drawn from a
generator seeded by ``(--seed, batch index)`` (JAX folds the same two numbers
into its key, so the two draw other noise). Each row is cut at the first
frame whose gate ``sigmoid > --gate-threshold``, unless that is frame 0 or
none is (then all ``--n-frames``). The vocoder takes the batch's longest row
rounded up to 128 frames (at most ``--n-frames``), and each wav is trimmed
to ``n · hop`` samples. ``--amp`` computes the model and the vocoder in bf16
(the weights stay f32). Writes ``utt_XXXX_mel.npy`` and, with a vocoder,
``utt_XXXX.wav``.

``--checkpoint`` is a ``flowtron_train`` checkpoint dir (with ``model.pt``),
or its run dir or ``checkpoints`` dir (the newest step); its
``model_config.json`` gives the config, else ``FlowtronConfig()``.

With no ``--device`` it serves on every visible card (``CUDA_VISIBLE_DEVICES``
picks them): each batch is rounded up to a multiple of the card count and
split over them, one replica of each model a card and one host thread a
replica, as the JAX CLI shards it (``utils/serving.py``).

Usage:
  python -m neuraltexttospeech_torch.cli.flowtron_infer --checkpoint out/flowtron \\
      -i phrases.txt -o out/mels --sigma 0.8 --n-frames 400 [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from ..data.filelist import save_wav
from ..models.flowtron import Flowtron, FlowtronConfig
from ..models.registry import WEIGHTS_FILE, find_model_config, load_checkpoint, load_model_config
from ..text.processing import TextProcessing
from ..train.checkpoint import checkpoint_dir
from ..utils.device import resolve_devices
from ..utils.generators import seeded_generator
from ..utils.serving import serve
from .hifigan_infer import load_generator


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("-i", "--input", required=True, help="text file, one utterance per line")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--sigma", type=float, default=0.8)
    p.add_argument("-bs", "--batch-size", type=int, default=8,
                   help="utterances per device batch; inputs are length-sorted and padded "
                        "to 16-token text buckets")
    p.add_argument("--n-frames", type=int, default=400)
    p.add_argument("--speaker", type=int, default=0)
    p.add_argument("--hifigan-checkpoint", default=None)
    p.add_argument("--amp", action="store_true",
                   help="bf16 compute for the model and the vocoder (weights stay f32)")
    p.add_argument("--gate-threshold", type=float, default=0.5)
    p.add_argument("--sampling-rate", type=int, default=22050)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: every visible card, each batch split "
                        "over them; CUDA_VISIBLE_DEVICES picks the cards)")
    return p.parse_args(argv)


def load_flowtron(path, device: torch.device, amp: bool = False) -> Flowtron:
    """The model of a checkpoint (run, ``checkpoints`` or step dir) in eval
    mode on ``device``, bf16 with ``amp``."""
    ckpt = checkpoint_dir(path)
    dtype = torch.bfloat16 if amp else None
    if find_model_config(ckpt):
        config = dataclasses.replace(load_model_config(ckpt)[1], dtype=dtype)
        return load_checkpoint(ckpt, "Flowtron", device, config=config)[0]
    model = Flowtron(FlowtronConfig(dtype=dtype))
    model.load_state_dict(torch.load(ckpt / WEIGHTS_FILE, map_location="cpu", weights_only=True))
    return model.to(device).eval()


def trim_lengths(gate_prob: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """Each row's frames: the first where ``gate_prob > threshold``, all of
    them when that is frame 0 or there is none."""
    fired = gate_prob > threshold
    stop = torch.argmax(fired.to(torch.uint8), dim=1)
    ok = fired.gather(1, stop[:, None])[:, 0] & (stop > 0)
    return torch.where(ok, stop, gate_prob.shape[1])


def synthesize(model, generator, encoded: Sequence[np.ndarray], *,
               device: Union[torch.device, Sequence[torch.device]], batch_size: int = 8,
               n_frames: int = 400, sigma: float = 0.8, speaker: int = 0, seed: int = 0,
               gate_threshold: float = 0.5, dtype: Optional[torch.dtype] = None,
               noise: Optional[Callable[[int, tuple], torch.Tensor]] = None):
    """The serving loop (``utils/serving.py::serve``). Yields ``(index, mel
    [n, n_mel], audio [n·hop] or None)`` per utterance, as f32 numpy, in
    batch order. ``noise(b, shape)`` gives batch b's unit-variance draws
    (default: ``randn`` from a generator seeded ``(seed, b)``); ``dtype`` is
    the vocoder's compute dtype.

    ``device`` is one device or a list, each batch split over it; ``z`` is
    drawn once for the whole batch on the first device and split like the
    text, so the draws are one device's."""
    first = resolve_devices(device)[0]
    n_mel = model.config.n_mel_channels

    def draws(b, rows):
        shape = (rows, n_frames, n_mel)
        z = (noise(b, shape).to(first) if noise is not None else
             torch.randn(shape, generator=seeded_generator(first, seed, b), device=first))
        return z, np.full(rows, speaker, np.int32)

    def acoustic(flowtron, b, text, lens, z, speakers):
        mel, gate, _ = flowtron.infer(z * sigma, speakers, text, lens)
        return mel, trim_lengths(torch.sigmoid(gate.float()), gate_threshold)

    return serve(model, generator, encoded, acoustic, device=device, batch_size=batch_size,
                 dtype=dtype, batch_inputs=draws)


def main(argv=None):
    args = parse_args(argv)
    devices = resolve_devices(args.device)
    model = load_flowtron(args.checkpoint, devices[0], args.amp)
    tp = TextProcessing("english_basic", ["english_cleaners"], p_arpabet=0.0)
    vocoder = None
    if args.hifigan_checkpoint:
        vocoder, _ = load_generator(args.hifigan_checkpoint, devices[0])

    out_dir = pathlib.Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    lines = [l.strip() for l in pathlib.Path(args.input).read_text(encoding="utf-8")
             .splitlines() if l.strip()]
    encoded = [np.asarray(tp.encode_text(l), np.int32) for l in lines]
    for j, mel, audio in synthesize(model, vocoder, encoded, device=devices,
                                    batch_size=args.batch_size, n_frames=args.n_frames,
                                    sigma=args.sigma, speaker=args.speaker, seed=args.seed,
                                    gate_threshold=args.gate_threshold,
                                    dtype=torch.bfloat16 if args.amp else None):
        np.save(out_dir / f"utt_{j:04d}_mel.npy", mel)
        if audio is not None:
            save_wav(str(out_dir / f"utt_{j:04d}.wav"), audio, args.sampling_rate)
        print(f"[{j}] {len(mel)} frames: {lines[j][:60]}")


if __name__ == "__main__":
    main()
