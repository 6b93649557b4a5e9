"""FastSpeech 2 inference CLI: text → mel with pitch, energy and duration
controls (→ wav with ``--hifigan-checkpoint``).

Port of ``fastspeech2/inference.py``: each line of text goes through the
front end the checkpoint recorded (``model_config.json``), the utterances
are served in length-sorted batches padded to 16-token buckets
(``utils/serving.py::text_batches``), the model predicts durations, pitch
and energy (scaled by the controls), the mels (the postnet's when the
model has one) cross to f32 at the host boundary, the vocoder's input is
the batch's longest ``dec_lens`` rounded up to a 128-frame bucket (at most
``--max-mel-len``), and each utterance is trimmed to ``dec_lens`` frames and
``dec_lens · hop`` samples. Writes ``utt_XXXX_mel.npy`` and, with a
vocoder, ``utt_XXXX.wav``.

With no ``--device`` it serves on every visible card (``CUDA_VISIBLE_DEVICES``
picks them): each batch is rounded up to a multiple of the card count and
split over them, one replica of each model a card and one host thread a
replica, as the JAX CLI shards it (``utils/serving.py``).

Usage:
  python -m neuraltexttospeech_torch.cli.fastspeech2_infer --checkpoint CKPT_DIR \\
      -i phrases.txt -o out/mels [--hifigan-checkpoint HG_DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import pathlib
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..data.filelist import save_wav
from ..models.registry import load_checkpoint, load_frontend_config
from ..text.processing import TextProcessing
from ..utils.device import resolve_devices
from ..utils.serving import serve
from .hifigan_infer import load_generator


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True, help="port FastSpeech 2 checkpoint dir")
    p.add_argument("-i", "--input", required=True, help="text file, one utterance per line")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--pitch-control", type=float, default=1.0)
    p.add_argument("--energy-control", type=float, default=1.0)
    p.add_argument("--duration-control", type=float, default=1.0)
    p.add_argument("--max-mel-len", type=int, default=1024)
    p.add_argument("--hifigan-checkpoint", default=None)
    p.add_argument("--amp", action="store_true",
                   help="bf16 compute for model + vocoder (weights stay f32)")
    p.add_argument("-bs", "--batch-size", type=int, default=8,
                   help="utterances per device batch; inputs are length-sorted and padded "
                        "to 16-token text buckets")
    p.add_argument("--sampling-rate", type=int, default=22050)
    p.add_argument("--device", default=None,
                   help="torch device (default: every visible card, each batch split "
                        "over them; CUDA_VISIBLE_DEVICES picks the cards)")
    return p.parse_args(argv)


def synthesize(model, generator, encoded: Sequence[np.ndarray], *,
               device: Union[torch.device, Sequence[torch.device]], max_mel_len: int = 1024,
               p_control: float = 1.0, e_control: float = 1.0, d_control: float = 1.0,
               batch_size: int = 8, dtype: Optional[torch.dtype] = None):
    """The serving loop (``utils/serving.py::serve``). Yields ``(index, mel
    [n, n_mel], audio [n·hop] or None)`` per utterance, as f32 numpy, in
    batch order. ``device`` is one device or a list, each batch split over
    it."""
    def acoustic(fs2, b, text, lens):
        out = fs2(text, lens, mel_max_len=max_mel_len, p_control=p_control,
                  e_control=e_control, d_control=d_control)
        return out.mel_postnet if out.mel_postnet is not None else out.mel_out, out.dec_lens

    return serve(model, generator, encoded, acoustic, device=device, batch_size=batch_size,
                 dtype=dtype, acoustic_dtype=dtype)


def main(argv=None):
    args = parse_args(argv)
    devices = resolve_devices(args.device)
    model, _ = load_checkpoint(args.checkpoint, "FastSpeech2", devices[0])
    fe = load_frontend_config(args.checkpoint, default={}) or {}
    tp = TextProcessing(fe.get("symbol_set", "english_basic"),
                        fe.get("text_cleaners", ["english_cleaners"]),
                        p_arpabet=fe.get("p_arpabet", 1.0))
    vocoder = None
    if args.hifigan_checkpoint:
        vocoder, _ = load_generator(args.hifigan_checkpoint, devices[0])

    out_dir = pathlib.Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    lines = [l.strip() for l in pathlib.Path(args.input).read_text(encoding="utf-8")
             .splitlines() if l.strip()]
    encoded = [np.asarray(tp.encode_text(l), np.int32) for l in lines]
    for j, mel, audio in synthesize(
            model, vocoder, encoded, device=devices, max_mel_len=args.max_mel_len,
            p_control=args.pitch_control, e_control=args.energy_control,
            d_control=args.duration_control, batch_size=args.batch_size,
            dtype=torch.bfloat16 if args.amp else None):
        np.save(out_dir / f"utt_{j:04d}_mel.npy", mel)
        if audio is not None:
            save_wav(str(out_dir / f"utt_{j:04d}.wav"), audio, args.sampling_rate)
        print(f"[{j}] {len(mel)} frames: {lines[j][:60]}")


if __name__ == "__main__":
    main()
