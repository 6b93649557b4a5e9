"""Dump an acoustic model's teacher-forced mels for vocoder fine-tuning.

Port of ``tools/dump_mels.py``: a trained FastPitch (its training forward,
aligned to the ground truth by MAS: the CUDA kernel on the card, once a
batch) or Tacotron 2 (its teacher-forced decode in eval mode, the postnet
mel) over a filelist's cached features, writing ``<wav-stem>_mel.npy`` per
utterance, trimmed to its mel length: the files ``hifigan_train
--fine-tuning-mel-dir`` reads.

The dataset is ``FastPitchDataset`` over ``-d`` with its defaults
(``english_cleaners_v2``, ARPAbet on), as in the JAX tool; Tacotron 2's
without pitch or prior. Tacotron 2's prenet drops out in every mode, so its
dropout comes from a generator seeded 7 for each batch, as
``tacotron2_infer``'s does (the JAX tool passes no dropout stream, and flax
refuses that call). ``--checkpoint`` is a training run, its ``checkpoints``
dir or one step; a FastPitch checkpoint must hold the aligner.

Usage:
  python -m neuraltexttospeech_torch.cli.dump_mels --model fastpitch \\
      --checkpoint out/fastpitch -d feats --training-files list.txt -o gen_mels [--device cpu]
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np
import torch

from ..data.dataset import FastPitchDataset
from ..models.registry import WEIGHTS_FILE, load_checkpoint
from ..train.checkpoint import checkpoint_dir
from ..utils.device import resolve_device
from .tacotron2_infer import PRENET_SEED, load_tacotron2


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", choices=["fastpitch", "tacotron2"], default="fastpitch")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("-d", "--dataset-path", required=True,
                   help="feature cache dir (from a prepare_dataset CLI)")
    p.add_argument("--training-files", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--n-speakers", type=int, default=1)
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    return p.parse_args(argv)


def load_aligner(path, device: torch.device):
    """A FastPitch checkpoint's model in eval mode, refusing one without the
    aligner's weights (a serving conversion), whose MAS would be random."""
    ckpt = checkpoint_dir(path)
    keys = torch.load(ckpt / WEIGHTS_FILE, map_location="cpu", weights_only=True)
    if not any(k.startswith("attention.") for k in keys):
        raise SystemExit(f"{ckpt} holds no aligner (attention.*): it cannot align")
    return load_checkpoint(ckpt, "FastPitch", device)[0]


def batches(ds: FastPitchDataset, batch_size: int):
    """``(indices, items, collated batch)`` over the dataset in file order."""
    for start in range(0, len(ds), batch_size):
        idxs = range(start, min(start + batch_size, len(ds)))
        items = [ds[i] for i in idxs]
        yield idxs, items, FastPitchDataset.collate(items)


def fastpitch_forward(model, batch, device, n_speakers: int = 1):
    """The training forward (no dropout) on a collated numpy batch."""
    t = {k: torch.as_tensor(v, device=device) for k, v in batch.items()
         if isinstance(v, np.ndarray)}
    with torch.no_grad():
        return model(t["text"], t["input_lens"], t["mel"], t["mel_lens"], t["pitch"],
                     t.get("energy"), t["speaker"] if n_speakers > 1 else None,
                     t["attn_prior"])


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    out_dir = pathlib.Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.model == "fastpitch":
        model = load_aligner(args.checkpoint, device)
        ds = FastPitchDataset(args.dataset_path, args.training_files,
                              n_speakers=args.n_speakers, device=device)

        def forward(batch):
            return fastpitch_forward(model, batch, device, args.n_speakers).mel_out
    else:
        model = load_tacotron2(args.checkpoint, device)
        ds = FastPitchDataset(args.dataset_path, args.training_files, n_speakers=args.n_speakers,
                              with_pitch=False, with_prior=False, device=device)

        def forward(batch):
            gen = torch.Generator(device=device)
            gen.manual_seed(PRENET_SEED)
            t = {k: torch.as_tensor(batch[k], device=device)
                 for k in ("text", "input_lens", "mel", "mel_lens")}
            with torch.no_grad():
                return model(t["text"], t["input_lens"], t["mel"], t["mel_lens"],
                             generator=gen).mel_out_postnet

    n_done = 0
    for _, items, batch in batches(ds, args.batch_size):
        mel_out = forward(batch).float().cpu().numpy()
        for j, it in enumerate(items):
            stem = pathlib.Path(it["audiopath"]).name.replace(".wav", "")
            np.save(out_dir / f"{stem}_mel.npy", mel_out[j, :int(batch["mel_lens"][j])])
        n_done += len(items)
        print(f"dumped {n_done}/{len(ds)}", flush=True)
    return n_done


if __name__ == "__main__":
    main()
