#!/usr/bin/env python3
"""Time the PyTorch port's v1 GAN step in a given checkout, to compare two
checkouts on one card.

    python3 tools/torch_gan_step_ab.py [--root DIR] [--mesh]

Imports ``neuraltexttospeech_torch`` from DIR (default: this checkout),
builds its kernels and runs ``chip_smoke.py``'s GAN-step timing on one HiFi-GAN
v1 trainer (batch 16 × 8192, f32, TF32 off, random weights): wall ms and
samples/s over 3 steps, the card's busy time and idle share, B2's share of
the kernel time, from this checkout's ``chip_smoke.py``. Run it for the two
checkouts in turns in one call (parent, change, change, parent), since the
host's speed, which sets the step's wall time, differs between machines.

With ``--mesh`` it times the step plain and on a one-rank NCCL data-parallel
mesh (``parallel/``, joined in this process) instead, in 8 turns of 3 calls,
then traces each once: the data-parallel path's own cost on one card.
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
    parser.add_argument("--mesh", action="store_true",
                        help="time the plain step against the step on a one-rank mesh")
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
    device = torch.device("cuda", 0)
    if not args.mesh:
        chip_smoke.phase_train_timing(torch, HiFiGANTrainer(HiFiGANConfig.v1(), device), card)
        return 0
    import socket

    import numpy as np
    import torch.distributed as dist
    from neuraltexttospeech_torch.parallel import initialize_distributed, make_mesh

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    if not initialize_distributed(f"127.0.0.1:{port}", 1, 0, device=device):
        raise RuntimeError("initialize_distributed did not join the one-rank run")
    try:
        trainers = {False: HiFiGANTrainer(HiFiGANConfig.v1(), device),
                    True: HiFiGANTrainer(HiFiGANConfig.v1(), device, mesh=make_mesh(1))}
        batch = {"audio": torch.as_tensor((np.random.default_rng(6).standard_normal(
            (16, 8192, 1)) * 0.1).astype(np.float32), device=device)}
        walls = {False: [], True: []}
        for dp in (False, True, True, False) * 2:
            walls[dp] += chip_smoke.timed_calls(
                torch, lambda: trainers[dp].train_step(batch), 3)[1]
        for dp in (False, True):
            wall = float(np.median(walls[dp]))
            chip_smoke.log(f"GAN step {'on a 1-rank mesh' if dp else 'plain'}, 8 turns of 3: "
                           f"median {wall * 1e3:.2f} ms (runs {chip_smoke.runs(walls[dp])}) "
                           f"[{card}]")
            chip_smoke.log("  trace: " + chip_smoke.trace_summary(
                torch, lambda: trainers[dp].train_step(batch), wall, top=2))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
