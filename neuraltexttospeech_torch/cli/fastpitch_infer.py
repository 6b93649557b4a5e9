"""FastPitch inference CLI: text → mel (→ wav via HiFi-GAN).

Port of ``fastpitch/inference.py``: reads lines of text, serves them in
length-sorted batches padded to 16-token buckets, rounds each batch's
decoded length up to a 128-frame vocoder bucket, vocodes, and trims every
utterance to ``dec_lens`` frames and ``dec_lens`` times the vocoder's hop
in samples. Writes mel
``.npy`` files and, with ``--hifigan-checkpoint``, 22 kHz wavs.

With no ``--device`` it serves on every visible card (``CUDA_VISIBLE_DEVICES``
picks them): each batch is rounded up to a multiple of the card count and
split over them, one replica of each model a card and one host thread a
replica, as the JAX CLI shards it (``utils/serving.py``).

Usage:
  python -m neuraltexttospeech_torch.cli.fastpitch_infer --checkpoint CKPT_DIR \
      -i phrases.txt -o out/wavs [--hifigan-checkpoint HG_DIR] [--device cpu]

Checkpoints are port checkpoints (``model.pt`` + ``model_config.json``, see
``tools/jax_to_torch_checkpoint.py``); the config file fixes the model's
dimensions, so the JAX CLI's dimension flags have no counterpart here.
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
from ..utils.serving import VOCODER_BUCKET, serve
from .hifigan_infer import load_generator


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True, help="port FastPitch checkpoint dir")
    p.add_argument("-i", "--input", required=True,
                   help="text file, one utterance per line")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--hifigan-checkpoint", default=None)
    p.add_argument("--amp", action="store_true",
                   help="bf16 compute for model + vocoder (weights stay f32)")
    p.add_argument("-bs", "--batch-size", type=int, default=8,
                   help="utterances per device batch; inputs are length-sorted "
                        "and padded to 16-token text buckets")
    p.add_argument("--pace", type=float, default=1.0)
    p.add_argument("--max-mel-len", type=int, default=2048)
    # default None: use the front-end recorded in the run's model_config.json
    p.add_argument("--text-cleaners", nargs="*", default=None)
    p.add_argument("--symbol-set", default=None)
    p.add_argument("--p-arpabet", type=float, default=None)
    p.add_argument("--sampling-rate", type=int, default=22050)
    p.add_argument("--device", default=None,
                   help="torch device (default: every visible card, each batch split "
                        "over them; CUDA_VISIBLE_DEVICES picks the cards)")
    return p.parse_args(argv)


def synthesize(fastpitch, generator, encoded: Sequence[np.ndarray], *,
               device: Union[torch.device, Sequence[torch.device]], batch_size: int = 8,
               pace: float = 1.0, max_mel_len: int = 2048, text_bucket: int = 16,
               frame_bucket: int = VOCODER_BUCKET, dtype: Optional[torch.dtype] = None):
    """The serving loop (``utils/serving.py::serve``). Yields ``(index, mel
    [n, n_mel], audio [n·hop] or None)`` per utterance, as f32 numpy, in
    batch order; ``index`` is the utterance's position in ``encoded``.

    ``device`` is one device or a list: each batch is split over the list
    in contiguous rows, one replica of each model a device, one thread a
    replica, and the vocoder bucket is taken over the whole batch, so the
    results equal one device's at the rounded batch.

    Text is padded to ``text_bucket`` tokens and the vocoder input to
    ``frame_bucket`` frames. Padding is not neutral: the predictors' second
    conv sees the first one's nonzero outputs at padded positions, so the
    last tokens' durations depend on the bucket, in the JAX CLI as here.

    With tracing on (``utils/profiling.py``) each batch is a ``serve.batch``
    span holding each replica's ``serve.acoustic``, ``serve.wait`` and the
    vocoder stage's spans.
    """
    def acoustic(fp, b, text, lens):
        return fp.infer(text, lens, pace=pace, max_mel_len=max_mel_len)[:2]

    return serve(fastpitch, generator, encoded, acoustic, device=device, batch_size=batch_size,
                 dtype=dtype, acoustic_dtype=dtype, text_bucket=text_bucket,
                 frame_bucket=frame_bucket)


def text_processing(checkpoint, symbol_set: Optional[str] = None,
                    cleaners: Optional[Sequence[str]] = None,
                    p_arpabet: Optional[float] = None) -> TextProcessing:
    """The front-end the checkpoint trained with, unless overridden."""
    fe = load_frontend_config(checkpoint, default={}) or {}
    return TextProcessing(
        symbol_set or fe.get("symbol_set", "english_basic"),
        cleaners if cleaners is not None else fe.get("text_cleaners",
                                                     ["english_cleaners_v2"]),
        p_arpabet=p_arpabet if p_arpabet is not None else fe.get("p_arpabet", 1.0))


def main(argv=None):
    args = parse_args(argv)
    devices = resolve_devices(args.device)
    model, _ = load_checkpoint(args.checkpoint, "FastPitch", devices[0])
    tp = text_processing(args.checkpoint, args.symbol_set, args.text_cleaners,
                         args.p_arpabet)
    generator = None
    if args.hifigan_checkpoint:
        generator, _ = load_generator(args.hifigan_checkpoint, devices[0])

    out_dir = pathlib.Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    lines = [l.strip() for l in pathlib.Path(args.input).read_text(encoding="utf-8")
             .splitlines() if l.strip()]
    encoded = [np.asarray(tp.encode_text(l), np.int32) for l in lines]
    for j, mel, audio in synthesize(
            model, generator, encoded, device=devices, batch_size=args.batch_size,
            pace=args.pace, max_mel_len=args.max_mel_len,
            dtype=torch.bfloat16 if args.amp else None):
        np.save(out_dir / f"utt_{j:04d}_mel.npy", mel)
        if audio is not None:
            save_wav(str(out_dir / f"utt_{j:04d}.wav"), audio, args.sampling_rate)
        print(f"[{j}] {len(mel)} frames: {lines[j][:60]}")


if __name__ == "__main__":
    main()
