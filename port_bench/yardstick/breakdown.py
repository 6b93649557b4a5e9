"""The reduction from a ``torch.profiler`` trace to the benchmark's device
numbers. ``category``, the kernel-name table and the union of device
intervals are frozen copies of ``utils/profiling.py``'s (``category``,
``_PORT_KERNELS``, ``_union_ms``); :func:`read` walks the profile's raw
records (not ``key_averages``, which takes seconds on 100k launches) into a
:class:`Trace`."""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, Iterable, List, Tuple

__all__ = ["CATEGORIES", "category", "union", "Trace", "read"]

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


def union(spans: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, stop)`` intervals."""
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(spans):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return busy


@dataclasses.dataclass
class Trace:
    """A traced stretch of the window (seconds throughout): ``window_s`` its
    length by the host's clock, ``busy_s`` the union of the device records'
    intervals, ``kernels`` each device record's name → (seconds, count),
    ``gaps`` the idle stretches between device records as (seconds, what
    the host was running), longest first."""

    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[float, int]]
    gaps: List[Tuple[float, str]]

    @property
    def launches(self) -> int:
        return sum(n for _, n in self.kernels.values())

    def seconds(self, cat: str) -> float:
        return sum(s for name, (s, _) in self.kernels.items() if category(name) == cat)

    def count(self, cat: str) -> int:
        return sum(n for name, (_, n) in self.kernels.items() if category(name) == cat)

    def breakdown(self, n: int = 10) -> dict:
        ops = sorted(((s, name) for name, (s, _) in self.kernels.items()), reverse=True)[:n]
        return {"device_ops": [[name[:160], s] for s, name in ops],
                "idle_gaps": [[what[:160], s] for s, what in self.gaps[:n]]}


def read(prof, window_s: float) -> Trace:
    """The :class:`Trace` of a finished ``torch.profiler.profile`` whose
    traced stretch lasted ``window_s`` seconds. GPU user annotations are
    ranges, not device work, and are left out. A gap is named by the host
    record (an ``aten::`` op or a CUDA runtime call) that overlaps it most,
    or ``host`` when none does."""
    from torch.autograd import DeviceType

    kernels: Dict[str, Tuple[float, int]] = {}
    spans, host = [], []
    for e in prof.profiler.kineto_results.events():
        name, start, dur = e.name(), e.start_ns() * 1e-9, e.duration_ns() * 1e-9
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation():
                continue
            total, count = kernels.get(name, (0.0, 0))
            kernels[name] = (total + dur, count + 1)
            spans.append((start, start + dur))
        elif name.startswith(("aten::", "cuda", "cu")):
            host.append((start, start + dur, name))
    spans.sort()
    gaps, end = [], None
    for start, stop in spans:
        if end is not None and start > end:
            gaps.append((end, start))
        end = stop if end is None else max(end, stop)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    host.sort()
    starts = [h[0] for h in host]
    named = []
    for g0, g1 in gaps:
        best, what = 0.0, "host"
        lo = bisect.bisect_left(starts, g0 - 1.0)
        for h0, h1, name in host[lo:bisect.bisect_right(starts, g1)]:
            overlap = min(h1, g1) - max(h0, g0)
            if overlap > best:
                best, what = overlap, name
        named.append((g1 - g0, what))
    return Trace(window_s, union(spans), kernels, named)
