"""Grad-TTS inference CLI: text → mel by N reverse-SDE steps (→ wav with
``--hifigan-checkpoint``), with the batch RTF.

Port of ``gradtts/inference.py``: each line of text goes through
``TextProcessing("english_basic", ["english_cleaners"], p_arpabet=1.0)``
and is interspersed with the blank id ``n_symbols - 1``; the utterances are
served in length-sorted batches padded to 16-token buckets; the mels cross
to f32 at the host boundary; the vocoder's input is the batch's longest
``ylen`` rounded up to a 128-frame bucket (at most ``--max-mel-len``), and
each utterance is trimmed to ``ylen`` frames and ``ylen · hop`` samples.
Writes ``utt_XXXX_mel.npy`` and, with a vocoder, ``utt_XXXX.wav``.

Batch ``b``'s randomness (the terminal noise, and with ``--stoc`` the
per-step noise) comes from a generator seeded with ``b``, as the JAX CLI
keys batch ``b`` with ``PRNGKey(b)``; the two draw other noise.

With no ``--device`` it serves on every visible card (``CUDA_VISIBLE_DEVICES``
picks them): each batch is rounded up to a multiple of the card count and
split over them, one replica of each model a card and one host thread a
replica, as the JAX CLI shards it (``utils/serving.py``).

Usage:
  python -m neuraltexttospeech_torch.cli.gradtts_infer --checkpoint CKPT_DIR \\
      -i phrases.txt -o out/mels [--hifigan-checkpoint HG_DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import pathlib
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..data.filelist import save_wav
from ..models.gradtts import fix_len_compatibility
from ..models.registry import load_checkpoint
from ..text.processing import TextProcessing, intersperse
from ..utils.device import resolve_devices
from ..utils.serving import Replicas, round_up, serving_sharding, text_batches
from .hifigan_infer import load_generator, vocode_replicas

VOCODER_BUCKET = 128  # frames


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True, help="port Grad-TTS checkpoint dir")
    p.add_argument("-i", "--input", required=True, help="text file, one utterance per line")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--timesteps", type=int, default=10)
    p.add_argument("--temperature", type=float, default=1.5)
    p.add_argument("--length-scale", type=float, default=1.0)
    p.add_argument("--stoc", action="store_true")
    p.add_argument("--hifigan-checkpoint", default=None)
    p.add_argument("--amp", action="store_true",
                   help="bf16 compute for model + vocoder (weights stay f32)")
    p.add_argument("-bs", "--batch-size", type=int, default=8,
                   help="utterances per device batch; inputs are length-sorted and padded "
                        "to 16-token text buckets")
    p.add_argument("--max-mel-len", type=int, default=1000)
    p.add_argument("--sampling-rate", type=int, default=22050)
    p.add_argument("--hop-length", type=int, default=256)
    p.add_argument("--device", default=None,
                   help="torch device (default: every visible card, each batch split "
                        "over them; CUDA_VISIBLE_DEVICES picks the cards)")
    return p.parse_args(argv)


def encode(lines: Sequence[str], n_symbols: int):
    """Each line as interspersed symbol ids (blank = ``n_symbols - 1``)."""
    tp = TextProcessing("english_basic", ["english_cleaners"], p_arpabet=1.0)
    return [np.asarray(intersperse(tp.encode_text(l), n_symbols - 1), np.int32) for l in lines]


def synthesize(model, generator, encoded: Sequence[np.ndarray], *,
               device: Union[torch.device, Sequence[torch.device]], n_timesteps: int = 10,
               temperature: float = 1.5, stoc: bool = False, length_scale: float = 1.0,
               batch_size: int = 8, max_mel_len: int = 1000, hop_length: int = 256,
               sampling_rate: int = 22050, frame_bucket: int = VOCODER_BUCKET,
               dtype: Optional[torch.dtype] = None):
    """The serving loop. Yields ``(index, mel [n, n_feats], audio [n·hop] or
    None, batch RTF)`` per utterance, as f32 numpy, in batch order.

    ``device`` is one device or a list, each batch split over it
    (``utils/serving.py``). Every replica draws from its own generator seeded
    ``b`` on the first device, at the whole batch's shape, and keeps its rows
    (``parallel/mesh.py::global_draw``): the draws are one device's."""
    devices = resolve_devices(device)
    put, replicate, batch_size = serving_sharding(batch_size, devices)
    models = replicate(model)
    generators = None if generator is None else replicate(generator)
    max_len = fix_len_compatibility(max_mel_len)
    with Replicas(devices) as replicas:
        for b, (idxs, text, lens) in enumerate(text_batches(encoded, batch_size)):
            t0 = time.perf_counter()

            def infer(i, text, lens):
                gen = torch.Generator(device=devices[0]).manual_seed(b)
                _, dec, _, ylen = models[i](text, lens, n_timesteps, temperature=temperature,
                                            stoc=stoc, length_scale=length_scale,
                                            max_mel_len=max_len, generator=gen)
                # the host boundary is f32 whatever the compute type; the fetch waits
                return dec.float(), ylen.cpu().numpy()

            decs, ylen = zip(*replicas.map(infer, put(text), put(lens), dtype=dtype))
            ylen = np.concatenate(ylen)
            frames = int(ylen[:len(idxs)].sum())
            rtf = (time.perf_counter() - t0) * sampling_rate / max(frames * hop_length, 1)
            M = min(round_up(int(ylen[:len(idxs)].max()), frame_bucket), max_len)
            dec, audio = vocode_replicas(replicas, generators, decs, M, dtype)
            for r, j in enumerate(idxs):
                n = int(ylen[r])
                yield (j, dec[r, :n], None if audio is None else audio[r, :n * hop_length],
                       rtf)


def main(argv=None):
    args = parse_args(argv)
    devices = resolve_devices(args.device)
    model, config = load_checkpoint(args.checkpoint, "GradTTS", devices[0])
    vocoder = None
    if args.hifigan_checkpoint:
        vocoder, _ = load_generator(args.hifigan_checkpoint, devices[0])

    out_dir = pathlib.Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    lines = [l.strip() for l in pathlib.Path(args.input).read_text(encoding="utf-8")
             .splitlines() if l.strip()]
    for j, mel, audio, rtf in synthesize(
            model, vocoder, encode(lines, config.n_symbols), device=devices,
            n_timesteps=args.timesteps, temperature=args.temperature, stoc=args.stoc,
            length_scale=args.length_scale, batch_size=args.batch_size,
            max_mel_len=args.max_mel_len, hop_length=args.hop_length,
            sampling_rate=args.sampling_rate, dtype=torch.bfloat16 if args.amp else None):
        np.save(out_dir / f"utt_{j:04d}_mel.npy", mel)
        if audio is not None:
            save_wav(str(out_dir / f"utt_{j:04d}.wav"), audio, args.sampling_rate)
        print(f"[{j}] {len(mel)} frames, batch RTF {rtf:.4f}: {lines[j][:50]}")


if __name__ == "__main__":
    main()
