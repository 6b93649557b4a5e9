#!/usr/bin/env python3
"""Measure the PyTorch port's host-fed training throughput through its real
trainer CLI loop (counterpart of ``tools/cli_throughput.py``).

Every step time of ``chip_smoke.py`` is a step on a batch already on the
card. This tool times the loop a user runs: the CLI's batcher, the prefetch
thread's copy to the card, the step, the metric and checkpoint bookkeeping.
It builds a synthetic corpus (``--items`` wavs at LJSpeech-like lengths,
listed ``--list-repeat`` times so an epoch has enough batches), caches the
FastPitch features with ``fastpitch_prepare_dataset`` (log-mels through B1
on the card, pitch on the host), runs the port's ``fastpitch_train`` or
``hifigan_train`` in a subprocess, and reports steps/s per epoch (epoch 0
pays the warm-up; the later epochs are the steady state) against the step
on the card alone (``--device-ms``, e.g. ``chip_smoke.py``'s step time):

    python3 -u tools/torch_cli_throughput.py fastpitch --device-ms 104.7
    python3 -u tools/torch_cli_throughput.py hifigan --epochs 2 --steps-per-epoch 8

The corpus and the runs go under ``--workdir`` (default ``out/cli_throughput``
in this checkout). ``--precision bf16`` (the default, as the JAX tool's
``--amp``) or ``f32``.
"""

from __future__ import annotations

import argparse
import pathlib
import re
import subprocess
import sys
from typing import Callable, List, Optional

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]

# A few distinct mel lengths (frames), as the JAX tool's: a realistic spread
# of bucket lengths
MEL_LENS = (640, 704, 768, 832)
HOP = 256
SR = 22050
WORDS = ("the quick brown fox jumps over a lazy dog while printing from "
         "movable type remains the great invention of the age").split()


def build_corpus(root: pathlib.Path, n_items: int, list_repeat: int):
    """``n_items`` synthetic wavs under ``root/wavs``, the filelist of each
    once (``root/items.txt``, for the feature cache) and the training
    filelist listing each ``list_repeat`` times (``root/train.txt``)."""
    sys.path.insert(0, str(REPO))
    from neuraltexttospeech_torch.data.filelist import save_wav

    wav_dir = root / "wavs"
    wav_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    lines = []
    for i in range(n_items):
        n = MEL_LENS[i % len(MEL_LENS)] * HOP
        p = wav_dir / f"utt{i:03d}.wav"
        if not p.exists():
            t = np.arange(n) / SR
            f0 = 110.0 + 10.0 * (i % 7)
            audio = (0.25 * np.sin(2 * np.pi * f0 * t) + 0.1 * np.sin(2 * np.pi * 2 * f0 * t)
                     + 0.03 * rng.standard_normal(n))
            save_wav(str(p), audio.astype(np.float32), SR)
        text = " ".join(WORDS[(i + j) % len(WORDS)] for j in range(18))
        lines.append(f"{p}|{text}.")
    items, train = root / "items.txt", root / "train.txt"
    items.write_text("\n".join(lines) + "\n")
    train.write_text("\n".join(lines * list_repeat) + "\n")
    return items, train


def fastpitch_rate(line: str) -> Optional[float]:
    """steps/s of ``fastpitch_train``'s epoch line (``fit_epoch``'s means)."""
    m = re.match(r"epoch \d+: .*steps_per_sec=([0-9.]+)", line)
    return float(m.group(1)) if m else None


def hifigan_rate(line: str) -> Optional[float]:
    """steps/s of ``hifigan_train``'s ``epoch N: <n> steps in <dt>s`` line."""
    m = re.match(r"epoch \d+: (\d+) steps in ([0-9.]+)s", line)
    return float(m.group(1)) / float(m.group(2)) if m and float(m.group(2)) > 0 else None


def run_cli(cmd: List[str], parse: Callable[[str], Optional[float]]) -> List[float]:
    """Run a CLI, echoing its output; returns the rates ``parse`` finds."""
    print("#", " ".join(cmd), flush=True)
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    rates = []
    for line in proc.stdout:
        line = line.rstrip()
        print(line, flush=True)
        rate = parse(line)
        if rate is not None:
            rates.append(rate)
    if proc.wait() != 0:
        raise SystemExit(f"{cmd[2]} failed with exit code {proc.returncode}")
    return rates


def summary(what: str, rates: List[float], device_ms: Optional[float]) -> List[str]:
    """The report: steps/s per epoch, the steady state (the best epoch after
    the first) in ms a step, and its ratio to the step on the card alone."""
    out = [f"{what} CLI loop: per-epoch steps/s = {[round(r, 3) for r in rates]}"]
    steady = max(rates[1:]) if len(rates) > 1 else (rates[0] if rates else 0.0)
    if steady:
        out.append(f"steady state: {steady:.3f} steps/s = {1e3 / steady:.1f} ms/step host-fed")
        if device_ms:
            out.append(f"step on the card alone: {device_ms:.1f} ms -> CLI efficiency "
                       f"{device_ms * steady / 1e3:.1%}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=["fastpitch", "hifigan"])
    ap.add_argument("--device-ms", type=float, default=None,
                    help="ms of the step on the card alone, for the ratio")
    ap.add_argument("--items", type=int, default=32)
    ap.add_argument("--list-repeat", type=int, default=24)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--steps-per-epoch", type=int, default=40)
    ap.add_argument("--precision", choices=["bf16", "f32"], default="bf16")
    ap.add_argument("--device", default=None, help="the CLIs' --device (default: cuda)")
    ap.add_argument("--workdir", default=str(REPO / "out" / "cli_throughput"))
    a = ap.parse_args(argv)

    root = pathlib.Path(a.workdir).resolve()
    items, train = build_corpus(root, a.items, a.list_repeat)
    device = [] if a.device is None else ["--device", a.device]
    amp = ["--amp"] if a.precision == "bf16" else []
    run = [sys.executable, "-u", "-m"]
    out = root / f"out_{a.what}"
    common = ["-o", str(out), "--training-files", str(train), "--epochs", str(a.epochs),
              "--steps-per-epoch", str(a.steps_per_epoch)] + amp + device
    if a.what == "fastpitch":
        feats = root / "feats"
        run_cli(run + ["neuraltexttospeech_torch.cli.fastpitch_prepare_dataset", "-d", str(feats),
                       "--training-files", str(items)] + device, lambda line: None)
        cmd = run + ["neuraltexttospeech_torch.cli.fastpitch_train", "-d", str(feats),
                     "-bs", str(a.batch_size)] + common
        rates = run_cli(cmd, fastpitch_rate)
    else:
        cmd = run + ["neuraltexttospeech_torch.cli.hifigan_train", "--batch-size",
                     str(a.batch_size)] + common
        rates = run_cli(cmd, hifigan_rate)
    print()
    for line in summary(f"{a.what} ({a.precision})", rates, a.device_ms):
        print(line, flush=True)
    return rates


if __name__ == "__main__":
    main()
