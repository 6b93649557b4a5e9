#!/usr/bin/env python3
"""Read the bf16 DiffWave train step's gradient error, card against CPU, in
a given checkout of the PyTorch port.

    python3 tools/torch_diffwave_bf16_grads.py [--root DIR] [--repeat N]

Imports ``neuraltexttospeech_torch`` from DIR (default: this checkout) and
runs one DiffWave ``Trainer`` step (Adam), f32 (TF32 off) and bf16, on the
card and on the CPU from the same random weights, steps and noise
(``chip_smoke.py::diffwave_steps``), at two shapes: chip_smoke's small
check (6 layers × 16 channels, batch 3 × 8 frames), run ``N`` times (default
3) to show whether the card's bf16 gradients change from run to run, and
the ``bench.py`` shape at full width (30 layers × 64 channels, batch 16 ×
62 frames). For each run it prints whether ``chip_smoke.py::check_bf16_step``
holds and, for the parameters farthest past their own bound and for
``skip_projection.bias``: |card bf16 - CPU bf16|, CPU bf16 vs CPU f32, card
bf16 vs card f32, and max |grad|. The full-width CPU steps take ~30 GiB of
host memory: run it on the card's machine, not on a small host.
"""

import argparse
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]


def report(chip_smoke, label, steps, lr):
    """Log the farthest parameters' errors and ``skip_projection.bias``'s;
    return whether ``check_bf16_step`` holds."""
    parts = [{k: v[i] for k, v in steps.items()} for i in range(3)]
    leaves = chip_smoke.bf16_grad_errors(parts[2])
    ratio = {k: e[0] / (2 * e[1] + 1e-3 * e[2]) if 2 * e[1] + 1e-3 * e[2] > 0 else 0.0
             for k, e in leaves.items()}
    far = sorted(ratio, key=ratio.get, reverse=True)[:4]
    for k in dict.fromkeys(far + ["skip_projection.bias"]):
        e = leaves[k]
        chip_smoke.log(f"  {label} {k}: {ratio[k]:.2f} of its bound; |card - CPU| {e[0]:.3e}, "
                       f"CPU bf16 vs f32 {e[1]:.3e}, card bf16 vs f32 {e[3]:.3e}, max|grad| "
                       f"{e[2]:.3e}")
    try:
        chip_smoke.check_bf16_step(label, *parts, lr)
    except RuntimeError as err:
        chip_smoke.log(f"{label}: FAILS: {err}")
        return "fails"
    return "holds"


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=pathlib.Path, default=ROOT,
                        help="checkout whose neuraltexttospeech_torch is read")
    parser.add_argument("--repeat", type=int, default=3,
                        help="runs of the small step, to see the card's run-to-run spread")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_diffwave_bf16_grads: no CUDA device is visible", file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    sys.path.insert(0, str(root))
    from neuraltexttospeech_torch.models.diffwave import DiffWaveConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    chip_smoke.log(f"checkout {root} [{card}]")

    small = DiffWaveConfig(residual_layers=6, residual_channels=16, crop_mel_frames=8)
    card_grads = []
    for run in range(args.repeat):
        weights, batch = chip_smoke.diffwave_step_inputs(torch, small, [2, 25, 47], 2,
                                                         np.random.default_rng(9))
        steps = chip_smoke.diffwave_steps(torch, small, weights, batch, device, 1e-3)
        report(chip_smoke, f"small step, run {run + 1}", steps, 1e-3)
        card_grads.append(steps[(True, "cuda")][2])
    spread = max((max((g[k] - card_grads[0][k]).abs().max().item() for k in g)
                  for g in card_grads[1:]), default=0.0)
    chip_smoke.log(f"small step: the card's bf16 gradients over {args.repeat} runs differ by at "
                   f"most {spread:.3e}")

    bench = DiffWaveConfig(crop_mel_frames=62)
    weights, batch = chip_smoke.diffwave_step_inputs(
        torch, bench, np.linspace(0, 49, 16).astype(int), 2, np.random.default_rng(9))
    steps = chip_smoke.diffwave_steps(torch, bench, weights, batch, device, 2e-4)
    verdict = report(chip_smoke, "bench-shape step (30 x 64, 16 x 62 frames)", steps, 2e-4)
    chip_smoke.log(f"bench-shape step: check_bf16_step {verdict}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
