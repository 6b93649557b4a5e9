"""Small shapes for rehearsing the benchmark on the CPU: the configurations'
widths cut so a run takes seconds, the traffic cut to match."""

from __future__ import annotations

import pathlib
import time

import torch

REPO = pathlib.Path(__file__).resolve().parents[2]

FASTPITCH = {"symbols_embedding_dim": 32, "in_fft_n_layers": 1, "out_fft_n_layers": 1,
             "in_fft_d_head": 8, "out_fft_d_head": 8, "in_fft_conv1d_filter_size": 64,
             "out_fft_conv1d_filter_size": 64, "dur_predictor_filter_size": 16,
             "pitch_predictor_filter_size": 16, "energy_predictor_filter_size": 16,
             "n_attn_channels": 8}
GENERATOR = {"upsample_initial_channel": 16}


def overrides(cell: str):
    """``(config overrides, mix overrides)`` of a cell's CPU rehearsal."""
    if "serve" in cell:
        return ({"fastpitch": FASTPITCH, "vocoder": GENERATOR},
                {"max_mel_len": 256, "check_requests": 2, "trace_units": 2})
    if cell == "fastpitch-lj.train":
        return ({"fastpitch": FASTPITCH},
                {"sentences_per_request": 4, "pool_batches": 5, "trace_units": 2})
    return ({"hifigan": {**GENERATOR, "batch_size": 2, "segment_size": 1024}},
            {"pool_batches": 4, "trace_units": 1})


def rehearse(cell: str, trace: bool = False, seconds: float = 0.5, seed: int = 2 ** 31 + 77,
             bench=REPO / "BENCHMARK.json"):
    from port_bench.harness import run

    torch.manual_seed(0)
    cfg, mix = overrides(cell)
    return run(cell, seed, seconds, trace, torch.device("cpu"), pathlib.Path(bench),
               time.time(), cfg, mix)


def cells():
    import json

    return [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
