"""Profiling and tracing utilities (counterpart of
``neuraltexttospeech_tpu/utils/profiling.py``, :20-63).

``trace`` records the host and the card with ``torch.profiler`` and writes a
Chrome trace (``chrome://tracing``, Perfetto) into a directory, where JAX
writes an XProf trace; ``annotate`` names a region inside it
(``torch.profiler.record_function``); ``StepTimer`` is a rolling
steps/s and items/s meter for training loops.

``breakdown`` reads a finished profile (its raw records, not the profiler's
``key_averages``, which take ~20 s on a trace of 100k launches) and
``chrome_breakdown`` the Chrome trace ``trace`` writes. Both give a
:class:`Breakdown`: the card's busy time as the union of its kernels'
intervals (kernels that overlap count once), the idle share of the traced
window, and the time and launches by kernel and by :func:`category` (GEMM,
cuDNN conv, elementwise, reduction, copy/memset, the port's kernels B1, B2
f32, B2 bf16 and MAS, other), each per step.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import json
import os
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch

__all__ = ["trace", "annotate", "StepTimer", "Breakdown", "breakdown", "chrome_breakdown",
           "load_chrome_trace", "category", "CATEGORIES"]


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (the CPU, and the card when there is one) and write
    its Chrome trace to ``logdir/trace_<pid>.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))


def annotate(name: str):
    """Named region inside a trace (``with annotate("decoder"): ...``)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Rolling steps/sec + items/sec meter for training loops."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: list[float] = []
        self._items: list[int] = []

    def tick(self, n_items: int = 1):
        self._times.append(time.perf_counter())
        self._items.append(n_items)
        if len(self._times) > self.window + 1:
            self._times.pop(0)
            self._items.pop(0)

    @property
    def steps_per_sec(self) -> Optional[float]:
        if len(self._times) < 2:
            return None
        dt = self._times[-1] - self._times[0]
        return (len(self._times) - 1) / dt if dt > 0 else None

    @property
    def items_per_sec(self) -> Optional[float]:
        if len(self._times) < 2:
            return None
        dt = self._times[-1] - self._times[0]
        return sum(self._items[1:]) / dt if dt > 0 else None


CATEGORIES = ("GEMM", "cuDNN conv", "elementwise", "reduction", "copy/memset", "B1", "B2 f32",
              "B2 bf16", "MAS", "other")

# The port's kernels by their entry points' names (``ops/csrc``).
_PORT_KERNELS = (
    ("B1", ("logmel_fft_kernel",)),
    ("B2 bf16", ("window_taps_bf16_kernel", "pack_weights_kernel_bf16")),
    ("B2 f32", ("tap_dots_tc_kernel", "pack_weights_kernel", "sum_splits_kernel")),
    ("MAS", ("mas_kernel",)),
)
_CONV = ("conv", "cudnn", "fprop", "dgrad", "wgrad", "winograd", "fft2d", "fft1d")
_GEMM = ("gemm", "gemv", "cutlass", "cublas", "nvjet", "xmma", "splitkreduce")
_REDUCTION = ("reduce", "softmax", "norm", "scan", "cumsum", "argmax", "sort", "topk")
_COPY = ("memcpy", "memset", "copy", "catarray")


def category(name: str) -> str:
    """The category of a device record by its name: the port's kernels
    first, then copies and memsets, convolutions (cuDNN's, and ATen's
    depthwise ones), GEMMs (cuBLAS, CUTLASS), reductions (norms and softmax
    among them), elementwise kernels; ``other`` for the rest (cuDNN's RNN
    kernels among them)."""
    for cat, names in _PORT_KERNELS:
        if any(k in name for k in names):
            # sum_splits_kernel serves both B2 forms: its output type says which
            if cat == "B2 f32" and "sum_splits_kernel" in name and "bfloat16" in name:
                return "B2 bf16"
            return cat
    low = name.lower()
    if any(m in low for m in ("rnn", "lstm", "gru")):  # cuDNN's recurrent kernels
        return "other"
    for cat, marks in (("copy/memset", _COPY), ("cuDNN conv", _CONV), ("GEMM", _GEMM),
                       ("reduction", _REDUCTION)):
        if any(m in low for m in marks):
            return cat
    if "elementwise" in low or "pointwise" in low or "fill" in low:
        return "elementwise"
    return "other"


@dataclasses.dataclass
class Breakdown:
    """What one trace of ``steps`` steps holds (times in ms, for the whole
    trace; the ``*_per_step`` methods divide by ``steps``).

    ``busy_ms`` is the union of the device records' intervals (kernels,
    copies, memsets); ``window_ms`` the span from the trace's first record to
    its last, host and device; ``kernels`` maps each device record's name to
    its (summed ms, count); ``runtime`` each host CUDA runtime or driver call
    to its (count, ms); ``ops`` each ``aten::`` op to its count (empty for a
    Chrome trace of the card's records only)."""

    steps: int
    busy_ms: float
    window_ms: float
    kernels: Dict[str, Tuple[float, int]]
    runtime: Dict[str, Tuple[int, float]]
    ops: Dict[str, int]

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_ms / self.window_ms if self.window_ms > 0 else 0.0

    @property
    def kernel_sum_ms(self) -> float:
        return sum(ms for ms, _ in self.kernels.values())

    @property
    def launches(self) -> int:
        """Device records (kernels, copies, memsets) in the trace."""
        return sum(n for _, n in self.kernels.values())

    def by_category(self) -> Dict[str, Tuple[float, int]]:
        """Each category's (summed ms, count) over the trace, every category
        present (zeros included), in :data:`CATEGORIES` order."""
        out = {cat: (0.0, 0) for cat in CATEGORIES}
        for name, (ms, n) in self.kernels.items():
            total, count = out[category(name)]
            out[category(name)] = (total + ms, count + n)
        return out

    def top(self, n: int = 20) -> List[Tuple[float, int, str]]:
        """The ``n`` device records that took most time: (ms, count, name)."""
        return sorted(((ms, c, name) for name, (ms, c) in self.kernels.items()),
                      reverse=True)[:n]

    def table(self, top: int = 20) -> str:
        """The summary, by category and by kernel, in ms a step with each
        one's share of the summed kernel time."""
        k, s = self.kernel_sum_ms or 1.0, self.steps
        lines = [f"card busy {self.busy_ms / s:.3f} ms/step of a {self.window_ms / s:.3f} ms/step "
                 f"window (idle share {self.idle_share:.3f}); kernel times sum to "
                 f"{self.kernel_sum_ms / s:.3f} ms/step, {self.launches / s:.1f} device records/"
                 f"step ({s} step{'s' if s != 1 else ''} traced)",
                 "", f"-- by category {'-' * 47}",
                 f"{'category':<14}{'ms/step':>10}{'%':>7}{'launches/step':>15}"]
        for cat, (ms, n) in sorted(self.by_category().items(), key=lambda kv: -kv[1][0]):
            lines.append(f"{cat:<14}{ms / s:>10.3f}{100 * ms / k:>7.1f}{n / s:>15.1f}")
        lines += ["", f"-- top {top} kernels {'-' * 43}",
                  f"{'ms/step':>10}{'%':>7}{'launches/step':>15}  kernel (category)"]
        for ms, n, name in self.top(top):
            lines.append(f"{ms / s:>10.3f}{100 * ms / k:>7.1f}{n / s:>15.1f}  "
                         f"{name[:90]} ({category(name)})")
        return "\n".join(lines)


def _union_ms(spans: Iterable[Tuple[float, float]]) -> float:
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(spans):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return busy


def breakdown(prof, steps: int = 1) -> Breakdown:
    """The :class:`Breakdown` of a finished ``torch.profiler.profile`` (its
    raw records: building the profiler's ``FunctionEvent``s took 17 s for a
    trace of 11k launches) of ``steps`` steps. GPU user annotations are
    ranges, not device work, and are left out."""
    from torch.autograd import DeviceType

    kernels: Dict[str, Tuple[float, int]] = {}
    ops: Dict[str, int] = {}
    runtime: Dict[str, Tuple[int, float]] = {}
    spans, first, last = [], float("inf"), float("-inf")
    for e in prof.profiler.kineto_results.events():
        name, start, dur = e.name(), e.start_ns() / 1e6, e.duration_ns() / 1e6
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation():
                continue
            total, count = kernels.get(name, (0.0, 0))
            kernels[name] = (total + dur, count + 1)
            spans.append((start, start + dur))
        elif name.startswith("aten::"):
            ops[name] = ops.get(name, 0) + 1
        elif name.startswith(("cuda", "cu")):
            count, total = runtime.get(name, (0, 0.0))
            runtime[name] = (count + 1, total + dur)
        first, last = min(first, start), max(last, start + dur)
    window = last - first if last > first else 0.0
    return Breakdown(steps, _union_ms(spans), window, kernels, runtime, ops)


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def load_chrome_trace(path: str) -> dict:
    """A Chrome trace: ``path`` itself, or the newest ``*.json`` in the
    directory ``path`` (where :func:`trace` writes ``trace_<pid>.json``)."""
    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "*.json")), key=os.path.getmtime)
        if not files:
            raise FileNotFoundError(f"no *.json trace in {path}")
        path = files[-1]
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def chrome_breakdown(trace_json: dict, steps: int = 1) -> Breakdown:
    """The :class:`Breakdown` of a Chrome trace that ``torch.profiler``
    exported (``traceEvents`` of phase ``X``, times in µs): its device
    records are those of category ``kernel``, ``gpu_memcpy`` and
    ``gpu_memset``, its host CUDA calls those of ``cuda_runtime`` and
    ``cuda_driver``, its ops the ``cpu_op`` records named ``aten::``."""
    kernels: Dict[str, Tuple[float, int]] = {}
    ops: Dict[str, int] = {}
    runtime: Dict[str, Tuple[int, float]] = {}
    spans, first, last = [], float("inf"), float("-inf")
    for e in trace_json.get("traceEvents", []):
        if e.get("ph") != "X" or "ts" not in e:
            continue
        name, cat = e.get("name", ""), e.get("cat", "")
        start, dur = float(e["ts"]) / 1e3, float(e.get("dur", 0.0)) / 1e3
        if cat in _DEVICE_CATS:
            total, count = kernels.get(name, (0.0, 0))
            kernels[name] = (total + dur, count + 1)
            spans.append((start, start + dur))
        elif cat in ("cuda_runtime", "cuda_driver"):
            count, total = runtime.get(name, (0, 0.0))
            runtime[name] = (count + 1, total + dur)
        elif cat == "cpu_op" and name.startswith("aten::"):
            ops[name] = ops.get(name, 0) + 1
        elif cat == "gpu_user_annotation":
            continue
        first, last = min(first, start), max(last, start + dur)
    window = last - first if last > first else 0.0
    return Breakdown(steps, _union_ms(spans), window, kernels, runtime, ops)
