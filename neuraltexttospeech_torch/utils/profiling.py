"""Profiling and tracing utilities (counterpart of
``neuraltexttospeech_tpu/utils/profiling.py``, :20-63).

``trace`` records the host and the card with ``torch.profiler`` and writes a
Chrome trace (``chrome://tracing``, Perfetto) into a directory, where JAX
writes an XProf trace; ``annotate`` names a region inside it
(``torch.profiler.record_function``); ``StepTimer`` is a rolling
steps/s and items/s meter for training loops.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

__all__ = ["trace", "annotate", "StepTimer"]


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
