"""Precompute FastPitch features: log-mel, pitch and beta-binomial priors.

Port of ``fastpitch/prepare_dataset.py``: reads a pipe-separated filelist and
writes ``.npy`` caches into ``--dataset-path``. The log-mels run through
kernel B1 on the card (one launch per wav); pitch runs on the host CPU.

Usage:
  python -m neuraltexttospeech_torch.cli.fastpitch_prepare_dataset \\
      --dataset-path out/feats --training-files filelists/ljs_audio_text_train.txt \\
      [--device cpu]
"""

from __future__ import annotations

import argparse
import time

from ..data.dataset import FastPitchDataset
from ..utils.device import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset-path", "-d", required=True)
    p.add_argument("--training-files", required=True)
    p.add_argument("--text-cleaners", nargs="*", default=["english_cleaners_v2"])
    p.add_argument("--symbol-set", default="english_basic")
    p.add_argument("--p-arpabet", type=float, default=1.0)
    p.add_argument("--n-speakers", type=int, default=1)
    p.add_argument("--sampling-rate", type=int, default=22050)
    p.add_argument("--filter-length", type=int, default=1024)
    p.add_argument("--hop-length", type=int, default=256)
    p.add_argument("--win-length", type=int, default=1024)
    p.add_argument("--mel-fmin", type=float, default=0.0)
    p.add_argument("--mel-fmax", type=float, default=8000.0)
    p.add_argument("--n-mel-channels", type=int, default=80)
    p.add_argument("--device", default=None,
                   help="torch device for the mels (default: cuda; 'cpu' runs the plain path)")
    return p.parse_args(argv)


def main(argv=None) -> FastPitchDataset:
    """Write the caches; returns the dataset."""
    args = parse_args(argv)
    ds = FastPitchDataset(
        args.dataset_path, args.training_files, text_cleaners=args.text_cleaners,
        symbol_set=args.symbol_set, p_arpabet=args.p_arpabet, n_speakers=args.n_speakers,
        sampling_rate=args.sampling_rate, filter_length=args.filter_length,
        hop_length=args.hop_length, win_length=args.win_length, mel_fmin=args.mel_fmin,
        mel_fmax=args.mel_fmax, n_mel_channels=args.n_mel_channels,
        device=resolve_device(args.device))
    t0 = time.perf_counter()
    ds.prepare()
    print(f"prepared {len(ds)} items in {time.perf_counter() - t0:.1f}s")
    return ds


if __name__ == "__main__":
    main()
