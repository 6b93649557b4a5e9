"""Profiling and tracing utilities (counterpart of
``neuraltexttospeech_tpu/utils/profiling.py``, :20-63).

``trace`` records the host and the card with ``torch.profiler`` and writes a
Chrome trace (``chrome://tracing``, Perfetto) into a directory, where JAX
writes an XProf trace.

The program's own spans and counters: :func:`span` marks a stage where the
work happens and :func:`count` adds to a count of the innermost open span.
They record only while a ``torch.profiler`` profile is recording (``trace``,
or any ``torch.profiler.profile`` block): tracing is off otherwise, and then
a span is one flag check and a shared no-op context, a count two flag
checks. :func:`tally` collects a block's counts on its thread whether or
not tracing is on, and keeps them from every span (``utils/graphs.py``
tallies what a captured body counts, and adds it on each traced replay).
On, a span is also a ``torch.profiler.record_function`` range, so the trace
shows it over its kernels, and its record is kept in memory with host stamps
on the clock of the profiler's own records (``time.time_ns``, the Unix-epoch
scale of ``KinetoEvent.start_ns``) and, given a CUDA device, CUDA events at
both ends on the current stream. :func:`spans` returns the finished records
(device times resolved), :func:`reset` clears them.

``breakdown`` reads a finished profile (its raw records, not the profiler's
``key_averages``, which take ~20 s on a trace of 100k launches) and
``chrome_breakdown`` the Chrome trace ``trace`` writes. Both give a
:class:`Breakdown`: the card's busy time as the union of its kernels'
intervals (kernels that overlap count once), the idle share of the traced
window, the time and launches by kernel and by :func:`category` (GEMM,
cuDNN conv, elementwise, reduction, copy/memset, the port's kernels B1, B2
f32, B2 bf16 and MAS, other), each per step, and the longest idle gaps
between device records, each named by the host op under it and the
innermost program span over that op.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import glob
import itertools
import json
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

from ..parallel.mesh import ServingReplica
from ..parallel.mesh import current as _current_mesh

__all__ = ["trace", "span", "count", "tally", "tracing", "counting", "spans", "reset",
           "SpanRecord", "Breakdown", "breakdown", "chrome_breakdown", "load_chrome_trace",
           "category", "CATEGORIES"]


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (the CPU, and the card when there is one) and write
    its Chrome trace to ``logdir/trace_<pid>.json``. The program's spans and
    counters record while it runs."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))


# ------------------------------------------------------------ spans and counters

@dataclasses.dataclass
class SpanRecord:
    """One finished span: ``id``, ``parent`` (the id of the innermost span
    open on the same thread when it opened, or None), the native ``thread``
    id, the serving ``replica`` index it ran in (None outside one), host
    stamps in ns on the profiler's clock, ``child_ns`` (the host time its
    children took), its ``counts`` and, for a span given a CUDA device,
    ``device_ms``: CUDA-event milliseconds between its two markers on the
    stream, which include any idle time of the stream between them."""

    name: str
    id: int
    parent: Optional[int]
    thread: int
    replica: Optional[int]
    start_ns: int
    end_ns: int = 0
    child_ns: int = 0
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    device_ms: Optional[float] = None
    events: Optional[tuple] = dataclasses.field(default=None, repr=False)

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def self_ms(self) -> float:
        """Host ms less the time its children took."""
        return (self.end_ns - self.start_ns - self.child_ns) / 1e6


_OFF = contextlib.nullcontext()
_local = threading.local()  # each thread's stack of open spans, and its open tally
_ids = itertools.count(1)
_finished: List[SpanRecord] = []
_tallies = 0  # tallies open in the process
_tally_lock = threading.Lock()


def tracing() -> bool:
    """Whether a ``torch.profiler`` profile is recording (the flag its
    ``__enter__`` sets), and so whether spans and counts record."""
    return _autograd_profiler._is_profiler_enabled


def counting() -> bool:
    """Whether a count records: tracing is on, or a :func:`tally` is open
    (on some thread: :func:`count` finds which)."""
    return _autograd_profiler._is_profiler_enabled or _tallies > 0


@contextlib.contextmanager
def tally():
    """Collect the counts this thread makes in the block into the dict it
    yields, whether or not tracing is on; they reach no span."""
    global _tallies
    prev = getattr(_local, "tally", None)
    out = _local.tally = {}
    with _tally_lock:
        _tallies += 1
    try:
        yield out
    finally:
        with _tally_lock:
            _tallies -= 1
        _local.tally = prev


def _stack() -> List[SpanRecord]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "device", "rf", "record")

    def __init__(self, name: str, device):
        self.name = name
        self.device = device if device is not None and torch.device(device).type == "cuda" \
            else None

    def __enter__(self) -> SpanRecord:
        stack = _stack()
        mesh = _current_mesh()
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        # the host stamps lie just inside the range, the device markers just
        # around the block
        rec = self.record = SpanRecord(
            self.name, next(_ids), stack[-1].id if stack else None, threading.get_native_id(),
            mesh.data_index if isinstance(mesh, ServingReplica) else None, time.time_ns())
        if self.device is not None:
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record(torch.cuda.current_stream(self.device))
        stack.append(rec)
        return rec

    def __exit__(self, *exc):
        rec = self.record
        if rec.events is not None:
            rec.events[1].record(torch.cuda.current_stream(self.device))
        stack = _stack()
        stack.pop()
        rec.end_ns = time.time_ns()
        self.rf.__exit__(*exc)
        if stack:
            stack[-1].child_ns += rec.end_ns - rec.start_ns
        _finished.append(rec)
        return False


def span(name: str, device=None):
    """A context manager marking one stage of the program: with tracing on
    (:func:`tracing`) a ``record_function`` range and a :class:`SpanRecord`
    (CUDA events at both ends with a CUDA ``device``); off, a shared no-op.
    Names start neither with ``aten::`` nor with ``cu``, which trace readers
    take for host ops, and hold no ``#``, which marks PyTorch's own ranges."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device)


def count(name: str, n: int = 1):
    """Add ``n`` to the count ``name`` of the innermost span open on this
    thread, with tracing on; a count outside every span is not kept. Inside
    a :func:`tally` the count goes to the tally instead."""
    if not (_autograd_profiler._is_profiler_enabled or _tallies):
        return
    tallied = getattr(_local, "tally", None)
    if tallied is not None:
        tallied[name] = tallied.get(name, 0) + n
        return
    if not _autograd_profiler._is_profiler_enabled:
        return
    stack = getattr(_local, "stack", None)
    if stack:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + n


def spans() -> List[SpanRecord]:
    """The finished spans since the last :func:`reset`, in the order they
    closed, each one's device time resolved (waiting for its end marker)."""
    out = list(_finished)
    for rec in out:
        if rec.events is not None:
            start, end = rec.events
            end.synchronize()
            rec.device_ms, rec.events = start.elapsed_time(end), None
    return out


def reset():
    """Forget the finished spans."""
    _finished.clear()


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
    Chrome trace of the card's records only); ``gaps`` the :data:`GAPS`
    longest idle stretches between device records, longest first, as (ms,
    the innermost program span over the host's work in the gap or ``""``,
    the host op or CUDA call that overlaps it most or ``"host"``)."""

    steps: int
    busy_ms: float
    window_ms: float
    kernels: Dict[str, Tuple[float, int]]
    runtime: Dict[str, Tuple[int, float]]
    ops: Dict[str, int]
    gaps: List[Tuple[float, str, str]]

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
        one's share of the summed kernel time, then the longest idle gaps."""
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
        if self.gaps:
            lines += ["", f"-- {len(self.gaps)} longest idle gaps {'-' * 40}",
                      f"{'ms':>10}  span / host op under it"]
        for ms, name, op in self.gaps:
            lines.append(f"{ms:>10.3f}  {name or '(no span)'} / {op[:70]}")
        return "\n".join(lines)


def _union_ms(spans: Iterable[Tuple[float, float]]) -> float:
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(spans):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return busy


GAPS = 10


def _is_program_span(name: str) -> bool:
    """A host range the program opened (:func:`span`), not one of PyTorch's
    own (``Optimizer.step#Adam.step``, ``ProfilerStep#3``)."""
    return "#" not in name


def _named_gaps(device: List[Tuple[float, float]], ranges: List[Tuple[float, float, str]],
                host: List[Tuple[float, float, str]], n: int = GAPS):
    """The ``n`` longest gaps between the ``device`` intervals, each as (ms,
    the innermost of ``ranges`` (the program's spans) over the host's work in
    it, the ``host`` record that overlaps it most); all times in ms. The span
    is the one over the middle of that record's overlap with the gap (of the
    gap, where no record overlaps it), so it holds the op named beside it."""
    gaps, end = [], None
    for start, stop in sorted(device):
        if end is not None and start > end:
            gaps.append((end, start))
        end = stop if end is None else max(end, stop)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
    host = sorted(host)
    starts = [h[0] for h in host]
    longest = max((h[1] - h[0] for h in host), default=0.0)
    out = []
    for g0, g1 in gaps:
        best, op, mid = 0.0, "host", (g0 + g1) / 2
        for h0, h1, hname in host[bisect.bisect_left(starts, g0 - longest):
                                  bisect.bisect_right(starts, g1)]:
            overlap = min(h1, g1) - max(h0, g0)
            if overlap > best:
                best, op, mid = overlap, hname, (max(h0, g0) + min(h1, g1)) / 2
        over = [r for r in ranges if r[0] <= mid <= r[1]]
        name = max(over, key=lambda r: (r[0], -r[1]))[2] if over else ""
        out.append((g1 - g0, name, op))
    return out


def breakdown(prof, steps: int = 1) -> Breakdown:
    """The :class:`Breakdown` of a finished ``torch.profiler.profile`` (its
    raw records: building the profiler's ``FunctionEvent``s took 17 s for a
    trace of 11k launches) of ``steps`` steps. GPU user annotations are
    ranges, not device work, and are left out; host ones are the program's
    spans that name the idle gaps."""
    from torch.autograd import DeviceType

    kernels: Dict[str, Tuple[float, int]] = {}
    ops: Dict[str, int] = {}
    runtime: Dict[str, Tuple[int, float]] = {}
    device, ranges, host = [], [], []
    first, last = float("inf"), float("-inf")
    for e in prof.profiler.kineto_results.events():
        name, start, dur = e.name(), e.start_ns() / 1e6, e.duration_ns() / 1e6
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation():
                continue
            total, n = kernels.get(name, (0.0, 0))
            kernels[name] = (total + dur, n + 1)
            device.append((start, start + dur))
        elif e.is_user_annotation():
            if _is_program_span(name):
                ranges.append((start, start + dur, name))
        elif name.startswith("aten::"):
            ops[name] = ops.get(name, 0) + 1
            host.append((start, start + dur, name))
        elif name.startswith(("cuda", "cu")):
            n, total = runtime.get(name, (0, 0.0))
            runtime[name] = (n + 1, total + dur)
            host.append((start, start + dur, name))
        first, last = min(first, start), max(last, start + dur)
    window = last - first if last > first else 0.0
    return Breakdown(steps, _union_ms(device), window, kernels, runtime, ops,
                     _named_gaps(device, ranges, host))


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
    ``cuda_driver``, its ops the ``cpu_op`` records named ``aten::``, the
    program's spans its ``user_annotation`` ranges."""
    kernels: Dict[str, Tuple[float, int]] = {}
    ops: Dict[str, int] = {}
    runtime: Dict[str, Tuple[int, float]] = {}
    device, ranges, host = [], [], []
    first, last = float("inf"), float("-inf")
    for e in trace_json.get("traceEvents", []):
        if e.get("ph") != "X" or "ts" not in e:
            continue
        name, cat = e.get("name", ""), e.get("cat", "")
        start, dur = float(e["ts"]) / 1e3, float(e.get("dur", 0.0)) / 1e3
        if cat in _DEVICE_CATS:
            total, n = kernels.get(name, (0.0, 0))
            kernels[name] = (total + dur, n + 1)
            device.append((start, start + dur))
        elif cat in ("cuda_runtime", "cuda_driver"):
            n, total = runtime.get(name, (0, 0.0))
            runtime[name] = (n + 1, total + dur)
            host.append((start, start + dur, name))
        elif cat == "cpu_op" and name.startswith("aten::"):
            ops[name] = ops.get(name, 0) + 1
            host.append((start, start + dur, name))
        elif cat == "user_annotation" and _is_program_span(name):
            ranges.append((start, start + dur, name))
        elif cat == "gpu_user_annotation":
            continue
        first, last = min(first, start), max(last, start + dur)
    window = last - first if last > first else 0.0
    return Breakdown(steps, _union_ms(device), window, kernels, runtime, ops,
                     _named_gaps(device, ranges, host))
