#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the machine it starts on.

    python3 port_bench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. Prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``; then ``checks``, each compared
number with its limit, which also end standard error. It needs as many
CUDA devices as the cell asks for and exits non-zero without them, and
when JAX or the JAX package is loaded.
"""

from __future__ import annotations

import os
import pathlib
import sys
import time


def process_start() -> float:
    """The process's start on ``time.time()``'s clock (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


STARTED = process_start()
REPO = pathlib.Path(__file__).resolve().parents[1]
CACHE = REPO / ".bench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = os.environ["USE_JAX"] = "0"
sys.path.insert(0, str(REPO))


def main(argv=None) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from port_bench.harness import Cell, forbidden_modules, run

    torch.set_num_threads(1)  # one process, few threads: the host work is the serial loop

    cell = Cell(args.workload, REPO / "BENCHMARK.json")
    chips = int(cell.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA device(s); this machine has {n}",
              file=sys.stderr)
        return 2
    result, checks = run(args.workload, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), REPO / "BENCHMARK.json", STARTED)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
