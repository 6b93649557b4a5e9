#!/usr/bin/env python3
"""Summarise a Chrome trace of the port into a table of where the card's
time goes (counterpart of ``tools/trace_breakdown.py``).

    python tools/torch_trace_breakdown.py out/gan_trace [--steps 3] [--top 20]

Reads the trace that ``utils/profiling.py::trace`` writes
(``trace_<pid>.json``; a directory takes its newest ``*.json``, or give the
file) and prints, in ms a step (the total over ``--steps``, the number of
traced steps), the card's busy time (the union of its kernels' intervals,
so kernels that overlap count once), the idle share of the traced window,
the time and launches by category (GEMM, cuDNN conv, elementwise,
reduction, copy/memset, the port's kernels B1, B2 f32, B2 bf16 and MAS,
other) and the top kernels, each with its share of the summed kernel time
(``utils/profiling.py::chrome_breakdown``).

The JAX tool's GB/s column has no counterpart: ``torch.profiler`` records
no bytes a kernel, and this tool does not estimate them.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def summarize(trace_path: str, steps: int = 1, top: int = 20):
    """Print the tables of the trace at ``trace_path``; returns its
    ``Breakdown``."""
    from neuraltexttospeech_torch.utils.profiling import chrome_breakdown, load_chrome_trace

    b = chrome_breakdown(load_chrome_trace(trace_path), steps)
    print(b.table(top), flush=True)
    return b


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace", help="a Chrome trace, or the directory holding it")
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--top", type=int, default=20)
    a = ap.parse_args(argv)
    return summarize(a.trace, a.steps, a.top)


if __name__ == "__main__":
    main()
