"""Tacotron 2 inference CLI: text → mel by the gate-stopped autoregressive
decode (→ wav with ``--hifigan-checkpoint``).

Port of ``tacotron2/inference.py``: each line through the ``english_basic``
front end (``--text-cleaners``, no ARPAbet), in length-sorted batches padded
to 16-token buckets (``utils/serving.py::text_batches``), through
``Tacotron2.infer``: the scan form of ``--max-decoder-steps`` steps without
the early stop, as the JAX CLI runs it, its prenet dropout drawn from a
generator seeded 7 for every batch (JAX's ``PRNGKey(7)``). The vocoder's
input is the batch's longest ``mel_lengths`` rounded up to a 128-frame bucket
(at most ``--max-decoder-steps``), and each wav is trimmed to ``n · hop``
samples. ``--amp`` computes the model and the vocoder in bf16 (the weights
stay f32). Writes ``utt_XXXX_mel.npy`` (``n`` frames of the postnet mel)
and, with a vocoder, ``utt_XXXX.wav``.

``--checkpoint`` is a ``tacotron2_train`` checkpoint dir (with ``model.pt``),
or its run dir or ``checkpoints`` dir (the newest step).

With no ``--device`` it serves on every visible card (``CUDA_VISIBLE_DEVICES``
picks them): each batch is rounded up to a multiple of the card count and
split over them, one replica of each model a card and one host thread a
replica, as the JAX CLI shards it (``utils/serving.py``).

Usage:
  python -m neuraltexttospeech_torch.cli.tacotron2_infer --checkpoint out/tacotron2 \\
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
from ..models.registry import load_checkpoint, load_model_config
from ..text.processing import TextProcessing
from ..train.checkpoint import checkpoint_dir
from ..utils.device import resolve_devices
from ..utils.serving import Replicas, round_up, serving_sharding, text_batches
from .hifigan_infer import load_generator, vocode_replicas

VOCODER_BUCKET = 128  # frames
PRENET_SEED = 7


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("-i", "--input", required=True, help="text file, one utterance per line")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--hifigan-checkpoint", default=None)
    p.add_argument("--amp", action="store_true",
                   help="bf16 compute for the model and the vocoder (weights stay f32; the "
                        "decoder's carry stays f32)")
    p.add_argument("-bs", "--batch-size", type=int, default=8,
                   help="utterances per device batch; inputs are length-sorted and padded "
                        "to 16-token text buckets")
    p.add_argument("--max-decoder-steps", type=int, default=1000)
    p.add_argument("--text-cleaners", nargs="*", default=["english_cleaners"])
    p.add_argument("--sampling-rate", type=int, default=22050)
    p.add_argument("--device", default=None,
                   help="torch device (default: every visible card, each batch split "
                        "over them; CUDA_VISIBLE_DEVICES picks the cards)")
    return p.parse_args(argv)


def load_tacotron2(path, device: torch.device, max_decoder_steps: int = 1000,
                   amp: bool = False):
    """The model of a checkpoint (run, ``checkpoints`` or step dir) in eval
    mode on ``device``, with the decode cap and, with ``amp``, bf16."""
    ckpt = checkpoint_dir(path)
    _, config = load_model_config(ckpt)
    config = dataclasses.replace(config, max_decoder_steps=max_decoder_steps,
                                 dtype=torch.bfloat16 if amp else None)
    return load_checkpoint(ckpt, "Tacotron2", device, config=config)[0]


def synthesize(model, generator, encoded: Sequence[np.ndarray], *,
               device: Union[torch.device, Sequence[torch.device]], batch_size: int = 8,
               dtype: Optional[torch.dtype] = None):
    """The serving loop. Yields ``(index, mel [n, n_mel], audio [n·hop] or
    None)`` per utterance, as f32 numpy, in batch order; ``dtype`` is the
    vocoder's compute dtype.

    ``device`` is one device or a list, each batch split over it
    (``utils/serving.py``). Every replica's prenet draws from its own
    generator seeded ``PRENET_SEED`` on the first device, at the whole batch's
    shape, and keeps its rows (``parallel/mesh.py::global_draw``); each runs
    all the decoder steps (the scan form), so the results are one device's."""
    devices = resolve_devices(device)
    put, replicate, batch_size = serving_sharding(batch_size, devices)
    models = replicate(model)
    generators = None if generator is None else replicate(generator)
    hop = 0 if generator is None else generator.config.hop_size

    def infer(i, text, lens):
        gen = torch.Generator(device=devices[0])
        gen.manual_seed(PRENET_SEED)
        out = models[i].infer(text, lens, generator=gen)
        # the fetch waits for the batch
        return out.mel_out_postnet.float(), out.mel_lengths.cpu().numpy()

    with Replicas(devices) as replicas:
        for idxs, text, lens in text_batches(encoded, batch_size):
            mels, n_all = zip(*replicas.map(infer, put(text), put(lens)))
            n_all = np.concatenate(n_all)
            M = min(round_up(max(int(n_all[:len(idxs)].max()), 1), VOCODER_BUCKET),
                    mels[0].shape[1])
            mel, audio = vocode_replicas(replicas, generators, mels, M, dtype)
            for r, j in enumerate(idxs):
                n = int(n_all[r])
                yield j, mel[r, :n], (None if audio is None else audio[r, :n * hop])


def main(argv=None):
    args = parse_args(argv)
    devices = resolve_devices(args.device)
    model = load_tacotron2(args.checkpoint, devices[0], args.max_decoder_steps, args.amp)
    tp = TextProcessing("english_basic", args.text_cleaners, p_arpabet=0.0)
    vocoder = None
    if args.hifigan_checkpoint:
        vocoder, _ = load_generator(args.hifigan_checkpoint, devices[0])

    out_dir = pathlib.Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    lines = [l.strip() for l in pathlib.Path(args.input).read_text(encoding="utf-8")
             .splitlines() if l.strip()]
    encoded = [np.asarray(tp.encode_text(l), np.int32) for l in lines]
    for j, mel, audio in synthesize(model, vocoder, encoded, device=devices,
                                    batch_size=args.batch_size,
                                    dtype=torch.bfloat16 if args.amp else None):
        np.save(out_dir / f"utt_{j:04d}_mel.npy", mel)
        if audio is not None:
            save_wav(str(out_dir / f"utt_{j:04d}.wav"), audio, args.sampling_rate)
        print(f"[{j}] {len(mel)} frames: {lines[j][:60]}")


if __name__ == "__main__":
    main()
