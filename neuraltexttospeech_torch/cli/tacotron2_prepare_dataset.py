"""Tacotron 2 dataset prep: cache the log-mels of a filelist.

Port of ``tacotron2/prepare_dataset.py``: ``FastPitchDataset(...,
p_arpabet=0.0, with_pitch=False, with_prior=False).prepare()`` writes
``<utt>_mel.npy`` for each wav of ``--training-files`` into
``--dataset-path``; each log-mel is one launch of kernel B1 on the card.

Usage:
  python -m neuraltexttospeech_torch.cli.tacotron2_prepare_dataset -d out/feats \\
      --training-files filelists/ljs_audio_text_train.txt [--device cpu]
"""

from __future__ import annotations

import argparse
import time

from ..data.dataset import FastPitchDataset
from ..utils.device import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-d", "--dataset-path", required=True)
    p.add_argument("--training-files", required=True)
    p.add_argument("--text-cleaners", nargs="*", default=["english_cleaners"])
    p.add_argument("--device", default=None,
                   help="torch device for the mels (default: cuda; 'cpu' runs the plain path)")
    return p.parse_args(argv)


def main(argv=None) -> FastPitchDataset:
    """Write the caches; returns the dataset."""
    args = parse_args(argv)
    ds = FastPitchDataset(args.dataset_path, args.training_files,
                          text_cleaners=args.text_cleaners, p_arpabet=0.0, with_pitch=False,
                          with_prior=False, device=resolve_device(args.device))
    t0 = time.perf_counter()
    ds.prepare()
    print(f"prepared {len(ds)} items in {time.perf_counter() - t0:.1f}s")
    return ds


if __name__ == "__main__":
    main()
