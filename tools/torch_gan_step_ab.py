#!/usr/bin/env python3
"""Time the PyTorch port's v1 GAN step in a given checkout, to compare two
checkouts on one card.

    python3 tools/torch_gan_step_ab.py [--root DIR]

Imports ``neuraltexttospeech_torch`` from DIR (default: this checkout),
builds its kernels and runs ``chip_smoke.py``'s GAN-step timing on one HiFi-GAN
v1 trainer (batch 16 × 8192, f32, TF32 off, random weights): wall ms and
samples/s over 3 steps, the card's busy time and idle share, B2's share of
the kernel time, from this checkout's ``chip_smoke.py``. Run it for the two
checkouts in turns in one call (parent, change, change, parent), since the
host's speed, which sets the step's wall time, differs between machines.
"""

import argparse
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=pathlib.Path, default=ROOT,
                        help="checkout whose neuraltexttospeech_torch is timed")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_gan_step_ab: no CUDA device is visible", file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    sys.path.insert(0, str(root))
    from neuraltexttospeech_torch.models.hifigan import HiFiGANConfig
    from neuraltexttospeech_torch.models.hifigan_gan import HiFiGANTrainer
    from neuraltexttospeech_torch.ops import _build, gouter_kernel, mel_kernel

    for source in (mel_kernel.SOURCE, gouter_kernel.SOURCE):
        _build.load(source)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    chip_smoke.log(f"checkout {root}")
    trainer = HiFiGANTrainer(HiFiGANConfig.v1(), torch.device("cuda", 0))
    chip_smoke.phase_train_timing(torch, trainer, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
