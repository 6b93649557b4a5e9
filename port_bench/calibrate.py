#!/usr/bin/env python3
"""The readings that a cell's limits are set from (``limits/<cell>.json``),
on the card, in one process:

    python3 port_bench/calibrate.py --workload NAME --seeds 1,2,3 \\
        --control-seeds 4,5,6 [--faults half_batch_step] [--seconds 4]

For each of ``--seeds`` it runs the cell (set-up, a short window at the
cell's own load, the check) and prints the compared numbers. For each of
``--control-seeds`` it prints the control's numbers: the reference put in
the program's place one precision below the configuration's (bf16 → fp8
e4m3 products, f32 → TF32), judged as the program is. Each of ``--faults``
(``faults.py``) is planted under a run of each control seed. One JSON
object a line; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def control_serving(cell, seed: int, device):
    """The control's serving numbers on the requests the seed's run would
    check first (``check_requests`` of them), against the f32 reference. The
    control serves each utterance alone: its text padded to its own
    ``text_bucket`` multiple, its mel to its own ``vocoder_bucket``
    multiple."""
    import numpy as np
    import torch

    from port_bench.drivers.serve import Serve
    from port_bench.reference.nets import Arith, round_durations
    from port_bench.yardstick import traffic
    from port_bench.yardstick.judge import reference_nets, serving_numbers

    cfg, mix = cell.config, cell.mix
    serve = Serve(cell.cell, cfg, mix, device, seed, cell.root)
    ref = serve.ref
    nets = reference_nets(ref, cfg, seed, device, serve.init_weights)
    low = Arith("fp8" if cfg["precision"] == "bf16" else "tf32")
    stream = traffic.Sentences(mix, seed, cell.root)
    bucket, max_len = int(mix["text_bucket"]), int(mix["max_mel_len"])
    utterances = []
    for k in range(int(mix["check_requests"])):
        for text in stream.request(k):
            ids = np.asarray(ref.encode(cfg, text), np.int64)
            width = traffic.round_up(len(ids), bucket)
            enc, dur = ref.durations(nets, low, torch.as_tensor(ids, device=device), width)
            mel = ref.decode(nets, low, enc, round_durations(dur), max_len)
            frames = min(traffic.round_up(len(mel), int(mix["vocoder_bucket"])), max_len)
            utterances.append({"text": text, "ids": ids, "width": width,
                               "vocoder_frames": frames, "durations": dur.cpu().numpy(),
                               "mel": mel.cpu().numpy(),
                               "audio": ref.vocode(nets, low, mel, frames).cpu().numpy()})
    return serving_numbers(ref, nets, cfg, mix, utterances, device)


def worst_leaves(low: dict, f32: dict, n: int = 3) -> dict:
    from port_bench.yardstick.judge import kept_leaves, leaf_gaps

    keep = kept_leaves(f32)
    out = {"left_out": sorted(set(f32["grad"]) - set(keep))}
    for key in ("grad", "update"):
        gaps = leaf_gaps(low[key], f32[key], keep)
        out[key] = sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
    return out


def control_training(cell, seed: int, device):
    import torch

    from port_bench.drivers.gan_train import init_weights, leaves_of
    from port_bench.reference import load_reference
    from port_bench.yardstick import synth
    from port_bench.yardstick.judge import training_numbers

    cfg, mix = cell.config, cell.mix
    h = cfg["hifigan"]
    ref = load_reference(pathlib.Path(__file__).parent, cell.cell["config"])
    nets = ref.build(cfg, torch.device("cpu"))
    leaves = leaves_of(nets)
    n = int(mix["pool_batches"])
    pool = synth.synthetic_wavs_device(n * h["batch_size"], h["segment_size"], seed ^ 0xDA7A,
                                       device).view(n, h["batch_size"], h["segment_size"], 1)
    batches = pool[:3].clone()
    f32 = ref.first_steps(cfg, mix, seed, device, batches, "f32", init_weights, leaves)
    low = ref.first_steps(cfg, mix, seed, device, batches, "tf32", init_weights, leaves)
    return training_numbers(low, f32), worst_leaves(low, f32)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--mix", action="append", default=[],
                   help="KEY=VALUE over the cell's traffic file (a number)")
    args = p.parse_args(argv)

    import torch

    from port_bench.faults import FAULTS
    from port_bench.harness import Cell, run

    device = torch.device("cuda")
    bench = REPO / "BENCHMARK.json"
    mix = {k: float(v) for k, v in (m.split("=", 1) for m in args.mix)}
    cell = Cell(args.workload, bench, mix_overrides=mix)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]

    def emit(kind, seed, numbers, **extra):
        print(json.dumps({"kind": kind, "seed": seed, "numbers": numbers, **extra}), flush=True)

    for seed in seeds:
        t = time.time()
        result, checks = run(args.workload, seed, args.seconds, False, device, bench, t,
                             mix_overrides=mix)
        emit("program", seed, {k: v for k, v, _ in checks}, seconds=time.time() - t,
             attempted=result["attempted"], metrics=result["metrics"])
    for seed in controls:
        t = time.time()
        if cell.mix["driver"] == "serve":
            emit("control", seed, control_serving(cell, seed, device), seconds=time.time() - t)
        else:
            numbers, leaves = control_training(cell, seed, device)
            emit("control", seed, numbers, seconds=time.time() - t, leaves=leaves)
    for fault in [f for f in args.faults.split(",") if f]:
        for seed in controls:
            t = time.time()
            with FAULTS[fault]():
                _, checks = run(args.workload, seed, args.seconds, False, device, bench, t,
                                mix_overrides=mix)
            emit(f"fault:{fault}", seed, {k: v for k, v, _ in checks}, seconds=time.time() - t)
    return 0


if __name__ == "__main__":
    sys.exit(main())
