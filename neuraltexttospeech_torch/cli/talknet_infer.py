"""TalkNet 2 inference CLI: text → mel through the three heads (grapheme
durations → pitch → spectrogram; → wav with ``--hifigan-checkpoint``).

Port of ``talknet/inference.py``: each line goes through the front end that
the duration checkpoint recorded, in length-sorted batches padded to
16-token buckets (``utils/serving.py::text_batches``). The durations are
``clip(round(d), 0, max_duration)`` (half to even, as ``jnp.round``), zero
past each text length; f0 is zeroed where ``sigmoid(voiced) ≤ 0.5``; the
pitch and spectrogram heads expand over ``--max-mel-len`` frames, and each
utterance keeps ``n = min(Σ durations, max_mel_len)`` of them. The vocoder's
input is the batch's longest ``n`` rounded up to a 128-frame bucket (at most
``--max-mel-len``), and each wav is trimmed to ``n · hop`` samples. All three
heads take the duration checkpoint's config; ``--amp`` computes their
embeddings and pitch conv in bf16 (the backbones stay f32, as in JAX) and
the vocoder in bf16. Writes ``utt_XXXX_mel.npy`` and, with a vocoder,
``utt_XXXX.wav``.

A checkpoint argument is a checkpoint dir of ``talknet_train`` (with
``model.pt``), or its run dir or ``checkpoints`` dir (the newest step).

With no ``--device`` it serves on every visible card (``CUDA_VISIBLE_DEVICES``
picks them): each batch is rounded up to a multiple of the card count and
split over them, one replica of each model a card and one host thread a
replica, as the JAX CLI shards it (``utils/serving.py``).

Usage:
  python -m neuraltexttospeech_torch.cli.talknet_infer --duration-checkpoint out/tn-dur \\
      --pitch-checkpoint out/tn-pitch --spectrogram-checkpoint out/tn-spec \\
      -i phrases.txt -o out/mels [--hifigan-checkpoint HG_DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..data.filelist import save_wav
from ..models.registry import load_checkpoint, load_frontend_config, load_model_config
from ..models.talknet import GraphemeDuration, PitchPredictor, SpectrogramModel
from ..text.processing import TextProcessing
from ..train.checkpoint import checkpoint_dir
from ..utils.device import resolve_devices
from ..utils.masking import mask_from_lens
from ..utils.serving import serve
from .hifigan_infer import load_generator


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--duration-checkpoint", required=True,
                   help="checkpoint, run or checkpoints dir of --model duration")
    p.add_argument("--pitch-checkpoint", required=True)
    p.add_argument("--spectrogram-checkpoint", required=True)
    p.add_argument("-i", "--input", required=True, help="text file, one utterance per line")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--max-mel-len", type=int, default=1024)
    p.add_argument("-bs", "--batch-size", type=int, default=8,
                   help="utterances per device batch; inputs are length-sorted and padded "
                        "to 16-token text buckets")
    p.add_argument("--hifigan-checkpoint", default=None)
    p.add_argument("--amp", action="store_true",
                   help="bf16 compute for the heads' embeddings and pitch conv and the "
                        "vocoder (weights stay f32)")
    p.add_argument("--sampling-rate", type=int, default=22050)
    p.add_argument("--device", default=None,
                   help="torch device (default: every visible card, each batch split "
                        "over them; CUDA_VISIBLE_DEVICES picks the cards)")
    return p.parse_args(argv)


def load_heads(duration, pitch, spectrogram, device: torch.device, amp: bool = False):
    """(GraphemeDuration, PitchPredictor, SpectrogramModel) in eval mode on
    ``device``, all with the duration checkpoint's config (bf16 heads with
    ``amp``)."""
    _, config = load_model_config(checkpoint_dir(duration))
    if amp:
        config = dataclasses.replace(config, dtype=torch.bfloat16)
    return tuple(load_checkpoint(checkpoint_dir(path), "TalkNet2", device, config=config,
                                 model_cls=cls)[0]
                 for path, cls in ((duration, GraphemeDuration), (pitch, PitchPredictor),
                                   (spectrogram, SpectrogramModel)))


def synth(heads, text: torch.Tensor, text_lens: torch.Tensor, max_mel_len: int):
    """The three heads on one padded batch: (mel [B, max_mel_len, n_mel]
    f32, n [B], durations [B, T_text])."""
    dur_model, pitch_model, spec_model = heads
    with torch.inference_mode():
        durs = dur_model(text, text_lens)
        durs = torch.clamp(torch.round(durs.float()), 0.0,
                           float(dur_model.config.max_duration))
        durs = durs * mask_from_lens(text_lens, text.shape[1]).to(durs.dtype)
        f0, voiced = pitch_model(text, durs, max_mel_len)
        f0 = torch.where(torch.sigmoid(voiced) > 0.5, f0.float(), torch.zeros((), device=f0.device))
        mel = spec_model(text, durs, f0, max_mel_len).float()
        n = torch.clamp_max(torch.sum(durs, dim=1).int(), max_mel_len)
    return mel, n, durs


def synthesize(heads, generator, encoded: Sequence[np.ndarray], *,
               device: Union[torch.device, Sequence[torch.device]], max_mel_len: int = 1024,
               batch_size: int = 8, dtype: Optional[torch.dtype] = None):
    """The serving loop (``utils/serving.py::serve``). Yields ``(index, mel
    [n, n_mel], audio [n·hop] or None)`` per utterance, as f32 numpy, in
    batch order; ``dtype`` is the vocoder's compute dtype. ``device`` is one
    device or a list, each batch split over it."""
    def acoustic(replica_heads, b, text, lens):
        return synth(replica_heads, text, lens, max_mel_len)[:2]

    return serve(tuple(heads), generator, encoded, acoustic, device=device,
                 batch_size=batch_size, dtype=dtype)


def main(argv=None):
    args = parse_args(argv)
    devices = resolve_devices(args.device)
    heads = load_heads(args.duration_checkpoint, args.pitch_checkpoint,
                       args.spectrogram_checkpoint, devices[0], args.amp)
    fe = load_frontend_config(checkpoint_dir(args.duration_checkpoint), default={}) or {}
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
    for j, mel, audio in synthesize(heads, vocoder, encoded, device=devices,
                                    max_mel_len=args.max_mel_len, batch_size=args.batch_size,
                                    dtype=torch.bfloat16 if args.amp else None):
        np.save(out_dir / f"utt_{j:04d}_mel.npy", mel)
        if audio is not None:
            save_wav(str(out_dir / f"utt_{j:04d}.wav"), audio, args.sampling_rate)
        print(f"[{j}] {len(mel)} frames: {lines[j][:60]}")


if __name__ == "__main__":
    main()
