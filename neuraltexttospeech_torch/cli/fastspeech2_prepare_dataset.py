"""FastSpeech 2 preprocessing CLI: MFA TextGrids → duration/pitch/energy/mel
and ``stats.json``.

Port of ``fastspeech2/prepare_dataset.py`` (``data/fs2_preprocess.py``): the
log-mels run through kernel B1 on the card (one launch per wav), pitch on
the host CPU. The flags name the paths; ``--config`` reads them and the
audio settings from the reference's ``preprocess.yaml`` instead, which
needs PyYAML (imported only then).

Usage:
  python -m neuraltexttospeech_torch.cli.fastspeech2_prepare_dataset \\
      --raw-path raw/LJSpeech --textgrid-path TextGrid/LJSpeech \\
      --out-dir preprocessed/LJSpeech --metadata metadata.csv [--device cpu]
  python -m neuraltexttospeech_torch.cli.fastspeech2_prepare_dataset --config preprocess.yaml
"""

from __future__ import annotations

import argparse
import pathlib

from ..data.fs2_preprocess import FS2Preprocessor
from ..utils.device import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default=None, help="preprocess.yaml (needs PyYAML)")
    p.add_argument("--raw-path", default=None)
    p.add_argument("--textgrid-path", default=None)
    p.add_argument("--out-dir", default=None)
    p.add_argument("--metadata", default=None,
                   help="LJSpeech metadata.csv (id|raw|normalized)")
    p.add_argument("--val-size", type=int, default=512)
    p.add_argument("--device", default=None,
                   help="torch device for the mels (default: cuda; 'cpu' runs the plain path)")
    return p.parse_args(argv)


def _yaml_settings(args) -> dict:
    """Paths (where no flag gives them) and audio settings from ``--config``."""
    try:
        import yaml
    except ImportError as e:
        raise RuntimeError("--config needs PyYAML, which is not installed; pass "
                           "--raw-path, --textgrid-path and --out-dir instead") from e
    with open(args.config, encoding="utf-8") as f:
        cfg = yaml.safe_load(f)
    path, pp = cfg["path"], cfg["preprocessing"]
    args.raw_path = args.raw_path or path["raw_path"]
    args.out_dir = args.out_dir or path["preprocessed_path"]
    args.textgrid_path = (args.textgrid_path
                          or str(pathlib.Path(path["preprocessed_path"]) / "TextGrid"))
    return dict(sampling_rate=pp["audio"]["sampling_rate"],
                hop_length=pp["stft"]["hop_length"], filter_length=pp["stft"]["filter_length"],
                win_length=pp["stft"]["win_length"], n_mel_channels=pp["mel"]["n_mel_channels"],
                mel_fmin=pp["mel"]["mel_fmin"], mel_fmax=pp["mel"]["mel_fmax"] or 8000.0,
                val_size=pp["val_size"], pitch_normalization=pp["pitch"]["normalization"],
                energy_normalization=pp["energy"]["normalization"])


def main(argv=None) -> dict:
    """Preprocess; returns the statistics."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    kw = {"val_size": args.val_size}
    if args.config:
        kw = _yaml_settings(args)
    if not (args.raw_path and args.textgrid_path and args.out_dir):
        raise SystemExit("--config or all of --raw-path/--textgrid-path/--out-dir required")

    metadata = []
    meta_file = args.metadata or str(pathlib.Path(args.raw_path) / "metadata.csv")
    with open(meta_file, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split("|")
            if len(parts) >= 2:
                metadata.append((parts[0], parts[-1]))

    pre = FS2Preprocessor(args.raw_path, args.textgrid_path, args.out_dir,
                          device=device, **kw)
    stats = pre.build_from_path(metadata)
    print("stats:", stats)
    return stats


if __name__ == "__main__":
    main()
