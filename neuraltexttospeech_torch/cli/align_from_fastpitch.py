"""FastSpeech 2 and TalkNet 2 training features from a trained FastPitch.

Port of ``tools/align_from_fastpitch.py``: the FastPitch training forward
over a filelist's cached features aligns each utterance by MAS (the CUDA
kernel on the card, once a batch) and gives per-token durations that sum to
its frame count, with the duration-averaged pitch and energy; it writes
``<stem>_{mel,duration,pitch,energy}.npy`` and ``<split>.txt``
(``stem|text``), the layout ``fastspeech2_train`` and ``talknet_train`` read,
and the front end beside them as ``frontend.json``.

The front end (cleaners, symbol set, ARPAbet probability) is the one the
checkpoint's ``model_config.json`` records, unless a flag overrides it; each
utterance's text is re-encoded with it and must give as many tokens as the
aligned sequence.

Usage:
  python -m neuraltexttospeech_torch.cli.align_from_fastpitch --checkpoint out/fastpitch \\
      -d feats --training-files list.txt -o preprocessed/ [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np

from ..data.dataset import FastPitchDataset
from ..models.registry import load_frontend_config
from ..text.processing import TextProcessing
from ..train.checkpoint import checkpoint_dir
from ..utils.device import resolve_device
from .dump_mels import batches, fastpitch_forward, load_aligner


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True, help="a fastpitch_train run, or one step")
    p.add_argument("-d", "--dataset-path", required=True)
    p.add_argument("--training-files", required=True)
    p.add_argument("-o", "--output", required=True, help="FastSpeech 2 preprocessed dir")
    p.add_argument("--split", default="train")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--text-cleaners", nargs="*", default=None,
                   help="override the front end recorded in the checkpoint's "
                        "model_config.json (default: the recorded one)")
    p.add_argument("--symbol-set", default=None)
    p.add_argument("--p-arpabet", type=float, default=None)
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    return p.parse_args(argv)


def main(argv=None):
    """Align; returns the ``<split>.txt`` lines."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    model = load_aligner(args.checkpoint, device)
    fe = load_frontend_config(checkpoint_dir(args.checkpoint), default={}) or {}
    cleaners = (args.text_cleaners if args.text_cleaners is not None
                else fe.get("text_cleaners", ["english_cleaners_v2"]))
    symbol_set = args.symbol_set or fe.get("symbol_set", "english_basic")
    p_arpabet = args.p_arpabet if args.p_arpabet is not None else fe.get("p_arpabet", 1.0)
    print(f"front-end: cleaners={cleaners} symbol_set={symbol_set} p_arpabet={p_arpabet}",
          flush=True)
    ds = FastPitchDataset(args.dataset_path, args.training_files, text_cleaners=cleaners,
                          symbol_set=symbol_set, p_arpabet=p_arpabet, device=device)
    tp = TextProcessing(symbol_set, cleaners, p_arpabet=p_arpabet)
    out = pathlib.Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    (out / "frontend.json").write_text(json.dumps({
        "text_cleaners": list(cleaners), "symbol_set": symbol_set, "p_arpabet": p_arpabet},
        indent=1))

    lines = []
    for idxs, items, batch in batches(ds, args.batch_size):
        o = fastpitch_forward(model, batch, device)
        if o.energy_tgt is None:
            raise SystemExit("the FastPitch checkpoint has no energy conditioning")
        durs, pitch, energy = (x.float().cpu().numpy()
                               for x in (o.attn_hard_dur, o.pitch_tgt, o.energy_tgt))
        for j, it in enumerate(items):
            stem = pathlib.Path(it["audiopath"]).name.replace(".wav", "")
            n_text, n_mel = len(it["text"]), it["mel"].shape[0]
            text_field = ds.audiopaths_and_text[idxs[j]][-1]
            n_check = len(tp.encode_text(text_field))
            if n_check != n_text:
                raise SystemExit(f"{stem}: the re-encode gives {n_check} tokens but the "
                                 f"alignment used {n_text}: front ends out of sync")
            d = durs[j, :n_text]
            if int(d.sum()) != n_mel:
                raise SystemExit(f"{stem}: durations sum to {d.sum()}, not {n_mel} frames")
            np.save(out / f"{stem}_mel.npy", it["mel"].astype(np.float32))
            np.save(out / f"{stem}_duration.npy", d)
            np.save(out / f"{stem}_pitch.npy", pitch[j, 0, :n_text])
            np.save(out / f"{stem}_energy.npy", energy[j, :n_text])
            lines.append(f"{stem}|{text_field}")
        print(f"aligned {len(lines)}/{len(ds)}", flush=True)
    (out / f"{args.split}.txt").write_text("\n".join(lines) + "\n")
    print(f"wrote {out / (args.split + '.txt')}")
    return lines


if __name__ == "__main__":
    main()
