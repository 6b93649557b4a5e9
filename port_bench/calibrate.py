#!/usr/bin/env python3
"""The readings that a cell's limits are set from (``limits/<cell>.json``),
on the card, in one process:

    python3 port_bench/calibrate.py --workload NAME --seeds 1,2,3 \\
        --control-seeds 4,5,6 [--faults half_batch_step] [--seconds 4]

For each of ``--seeds`` it runs the cell (set-up, a short window at the
cell's own load, the check) and prints the compared numbers. For each of
``--control-seeds`` it prints the control's numbers: the reference put in
the program's place one precision below the configuration's (bf16 → fp8
e4m3 products, f32 → TF32), judged as the program is; a cell's control is
its driver's ``control(cell, seed, device)``, beside the driver's class in
``drivers/<driver>.py``. Each of ``--faults`` (``planted/<name>.py``,
found by ``faults.find``) is planted under a run of each control seed. One
JSON object a line; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def load_control(cell):
    """``drivers/<driver>.py::control`` of the cell's traffic's driver."""
    from port_bench.reference import load_by_path

    return load_by_path(cell.root / "drivers" / f"{cell.mix['driver']}.py",
                        "port_bench.drivers").control


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

    from port_bench.faults import find
    from port_bench.harness import Cell, run

    device = torch.device("cuda")
    bench = REPO / "BENCHMARK.json"
    mix = {k: float(v) for k, v in (m.split("=", 1) for m in args.mix)}
    cell = Cell(args.workload, bench, mix_overrides=mix)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    faults = {f: find(f, cell.root) for f in args.faults.split(",") if f}

    def emit(kind, seed, numbers, **extra):
        print(json.dumps({"kind": kind, "seed": seed, "numbers": numbers, **extra}), flush=True)

    for seed in seeds:
        t = time.time()
        result, checks = run(args.workload, seed, args.seconds, False, device, bench, t,
                             mix_overrides=mix)
        emit("program", seed, {k: v for k, v, _ in checks}, seconds=time.time() - t,
             attempted=result["attempted"], metrics=result["metrics"])
    control = load_control(cell)
    for seed in controls:
        t = time.time()
        numbers, extra = control(cell, seed, device)
        emit("control", seed, numbers, seconds=time.time() - t, **extra)
    for fault, planted in faults.items():
        for seed in controls:
            t = time.time()
            with planted():
                _, checks = run(args.workload, seed, args.seconds, False, device, bench, t,
                                mix_overrides=mix)
            emit(f"fault:{fault}", seed, {k: v for k, v, _ in checks}, seconds=time.time() - t)
    return 0


if __name__ == "__main__":
    sys.exit(main())
