"""Background batch prefetching with pinned, non-blocking host-to-device copies.

Counterpart of ``neuraltexttospeech_tpu/data/prefetch.py``: a producer
thread collates the next batch while the device runs the current step. For
a CUDA device the thread also copies the batch to the card from pinned host
memory on a side stream; the consumer's stream waits for that copy before it
uses the tensors.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

__all__ = ["prefetch"]

_SENTINEL = object()


def _to_device(item: dict, device: torch.device, stream):
    """The numpy arrays and host tensors of ``item`` as tensors on
    ``device`` (other values, and tensors already on a card, pass through),
    and the event that marks the end of their copy."""
    out = {}
    for k, v in item.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        if stream is not None and isinstance(v, torch.Tensor) and not v.is_cuda:
            with torch.cuda.stream(stream):
                v = v.pin_memory().to(device, non_blocking=True)
        out[k] = v
    if stream is None:
        return out, None
    event = torch.cuda.Event()
    event.record(stream)
    return out, event


def prefetch(iterable: Iterable[dict], device, buffer_size: int = 2) -> Iterator[dict]:
    """Yield the dicts of ``iterable`` with their numpy arrays and host
    tensors as tensors on ``device``, produced by a background thread."""
    device = torch.device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    q: queue.Queue = queue.Queue(maxsize=buffer_size)
    error: list = []
    stop = threading.Event()

    def producer():
        try:
            for item in iterable:
                if stop.is_set():
                    return
                q.put(_to_device(item, device, stream))
        except BaseException as e:  # propagate into the consumer
            error.append(e)
        finally:
            q.put(_SENTINEL)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if error:
                    raise error[0]
                return
            batch, event = item
            if event is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(event)
                for v in batch.values():
                    if isinstance(v, torch.Tensor):
                        v.record_stream(current)  # allocated on the side stream
            yield batch
    finally:
        stop.set()
