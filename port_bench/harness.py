"""One run of one cell: set-up, the measured window, the metrics, and the
comparison that decides ``correct``.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``; its configuration in the file that names
(``configs/<config>.json``); its traffic in ``traffic/<traffic>.json``,
whose ``driver`` names the loop, ``drivers/<driver>.py`` (its class is the
module's ``Driver``, and ``calibrate.py``'s control its ``control``); its
limits in
``limits/<cell>.json``; its FLOP and byte counts in ``counts/<config>.py``;
its reference in ``reference/<config>.py``; and each per-layer metric's
reader in ``metrics/<metric>.py``. A new cell is a ``workloads`` entry and
these files.
"""

from __future__ import annotations

import gc
import json
import pathlib
import sys
import time
from types import SimpleNamespace

import torch

from .reference import load_by_path

ROOT = pathlib.Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "neuraltexttospeech_tpu")

__all__ = ["Cell", "run", "forbidden_modules", "select_metrics"]


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Cell:
    """A workload of ``BENCHMARK.json`` with every file it names."""

    def __init__(self, name: str, bench_file: pathlib.Path, config_overrides=None,
                 mix_overrides=None):
        self.bench = json.loads(bench_file.read_text())
        self.repo = bench_file.parent
        self.root = self.repo / ROOT.name
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in {bench_file.name}: {sorted(cells)}")
        self.cell = cells[name]
        entry = {c["name"]: c for c in self.bench["configs"]}[self.cell["config"]]
        self.config = json.loads((self.repo / entry["file"]).read_text())
        for key, value in (config_overrides or {}).items():
            self.config[key] = {**self.config[key], **value} if isinstance(value, dict) else value
        self.mix = json.loads((self.root / "traffic" / f"{self.cell['traffic']}.json").read_text())
        self.mix.update(mix_overrides or {})
        self.limits = json.loads((self.root / "limits" / f"{name}.json").read_text())["limits"]
        self.counts = load_by_path(self.root / "counts" / f"{self.cell['config']}.py",
                                   "port_bench.counts")

    def metrics(self, trace: bool):
        return select_metrics(self.bench, self.cell["name"], trace)


def select_metrics(bench: dict, cell: str, trace: bool):
    """The cell's end-to-end metrics (``trace`` false) or its per-layer ones."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]


def run(workload: str, seed: int, seconds: float, trace: bool, device: torch.device,
        bench_file: pathlib.Path, started: float, config_overrides=None, mix_overrides=None):
    """Run the cell once; returns ``(result, checks)``: the result line's
    object and ``[(name, value, limit)]``. ``started`` is the process's
    start on ``time.time()``'s clock; the overrides shrink a cell for the
    rehearsals on the CPU."""
    c = Cell(workload, bench_file, config_overrides, mix_overrides)
    loop = load_by_path(c.root / "drivers" / f"{c.mix['driver']}.py", "port_bench.drivers").Driver
    driver = loop(c.cell, c.config, c.mix, device, seed, c.root)
    driver.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.time() - started
    gc.collect()
    gc.freeze()  # set-up's objects stay out of the collector's way
    gc.disable()
    try:
        driver.window(seconds, int(c.mix["trace_units"]) if trace else 0)
    finally:
        gc.enable()
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0)
    ctx = SimpleNamespace(cell=c.cell, config=c.config, mix=c.mix, counts=c.counts,
                          extras=driver.extras, trace=driver.extras.get("trace"))
    metrics = {}
    if trace:
        for m in c.metrics(True):
            reader = load_by_path(c.root / "metrics" / f"{m['name']}.py", "port_bench.metrics")
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        e2e = dict(driver.end_to_end(), setup_s=setup_s)
        for m in c.metrics(False):
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
    for line in driver.extras.get("notes", []):
        print(line, file=sys.stderr)
    checks = driver.check(c.limits)
    result = {"correct": all(v <= lim for _, v, lim in checks),
              "attempted": int(driver.extras["attempted"]),
              "failed": int(driver.extras["failed"]),
              "metrics": metrics,
              "device": device_info(device, peak)}
    tr = ctx.trace
    if trace and tr is not None:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    return result, checks


def device_info(device: torch.device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(peak), "power_limit": power_limit()}


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
