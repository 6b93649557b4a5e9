"""Batched-serving helpers for the inference CLIs.

Counterpart of ``neuraltexttospeech_tpu/utils/serving.py``: length-sort the
utterances, batch them, and pad each batch to a coarse text-length bucket.
PyTorch runs eagerly, so the buckets no longer bound a compile count; they
are kept so the port serves the same padded shapes as the JAX CLI, which
the parity tests rely on.

With several devices a batch is served as JAX serves it on a 1-D
``('data',)`` mesh of every device: :func:`serving_sharding` rounds the
batch up to a multiple of the device count, gives device ``i`` the
contiguous rows ``[i·B/N, (i+1)·B/N)`` and one replica of each model, and
:class:`Replicas` runs the replicas, one host thread a device (the per-frame
loops are host-bound: one thread issuing to N cards would give each 1/N of
it). JAX computes every batch-level quantity over the whole batch, so a
replica does too: its random draws are its rows of the global draw
(``parallel/mesh.py::ServingReplica``), and the CLIs take the vocoder's
frame bucket over every replica's lengths.
"""

from __future__ import annotations

import contextlib
import copy
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Callable, List, Sequence, Union

import numpy as np
import torch

from ..nn.precision import compute_dtype
from ..parallel.mesh import ServingReplica
from .device import resolve_devices

__all__ = ["round_up", "text_batches", "serving_sharding", "Replicas"]

Devices = Union[str, torch.device, Sequence[Union[str, torch.device]]]


def round_up(n: int, multiple: int) -> int:
    return -(-int(n) // multiple) * multiple


def _module_device(module: torch.nn.Module) -> torch.device:
    for t in module.parameters():
        return t.device
    for t in module.buffers():
        return t.device
    return torch.device("cpu")


def serving_sharding(batch_size: int, devices: Devices):
    """Serving placement over N devices (a device, or a list of them):
    ``(put, replicate, batch_size)``.

    ``batch_size`` is rounded up to a multiple of N (``text_batches``
    zero-pads the last batch, so it always divides; one device leaves it as
    it is); ``put(x)`` (numpy or a tensor) returns N tensors, device ``i``
    holding rows ``[i·B/N, (i+1)·B/N)``, the rows JAX's
    ``NamedSharding(Mesh(devices, ('data',)), P('data'))`` places on device
    ``i``; ``replicate(module)`` returns one model a device: the first entry
    on the module's own device is the module, every other one a deep copy
    moved to its device, with its buffers, in eval mode and sharing no
    storage with it (so no two threads run one module). A tuple of modules
    gives a tuple a device."""
    batch_size = max(1, int(batch_size))
    devices = resolve_devices(devices)
    n = len(devices)

    def put(x) -> List[torch.Tensor]:
        x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} rows do not split over {n} devices")
        b = x.shape[0] // n
        return [x[i * b:(i + 1) * b].to(dev) for i, dev in enumerate(devices)]

    def replicate(module):
        if isinstance(module, (tuple, list)):
            return [tuple(r) for r in zip(*(replicate(m) for m in module))]
        src, out, kept = _module_device(module), [], False
        for dev in devices:
            if dev == src and not kept:
                out.append(module)
                kept = True
            else:
                out.append(copy.deepcopy(module).to(dev).eval())
        return out

    return put, replicate, round_up(batch_size, n)


class Replicas:
    """Runs one function a replica, one host thread a device.

    :meth:`map` calls ``fn(i, *args_i)`` for every replica ``i``, on that
    replica's own thread (the caller's when there is one device), inside
    ``torch.cuda.device`` of its device, ``torch.inference_mode()``,
    ``compute_dtype(dtype)`` and ``ServingReplica(N, i)``: each is a
    thread-local setting, so each thread enters it itself. The results come
    back in replica order once every replica has finished; a replica's
    exception is raised in the caller, and nothing falls back to fewer
    devices. Use it as a context manager, which stops the threads."""

    def __init__(self, devices: Devices):
        self.devices = resolve_devices(devices)
        n = len(self.devices)
        self._pools = ([ThreadPoolExecutor(1, thread_name_prefix=f"replica{i}")
                        for i in range(n)] if n > 1 else [])

    def __len__(self) -> int:
        return len(self.devices)

    def __enter__(self) -> "Replicas":
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def close(self):
        for pool in self._pools:
            pool.shutdown()
        self._pools = []

    def _call(self, i: int, fn: Callable, args, dtype):
        dev = self.devices[i]
        with contextlib.ExitStack() as stack:
            if dev.type == "cuda":
                stack.enter_context(torch.cuda.device(dev))
            stack.enter_context(torch.inference_mode())
            stack.enter_context(compute_dtype(dtype))
            stack.enter_context(ServingReplica(len(self.devices), i))
            return fn(i, *args)

    def map(self, fn: Callable, *chunks: Sequence, dtype=None) -> list:
        """``[fn(i, chunks[0][i], chunks[1][i], ...) for each replica i]``,
        each in replica ``i``'s thread and contexts (``dtype``: the compute
        dtype of ``nn/precision.py``, None for the inputs' own)."""
        n = len(self.devices)
        args = [tuple(c[i] for c in chunks) for i in range(n)]
        if n == 1:
            return [self._call(0, fn, args[0], dtype)]
        if not self._pools:
            raise RuntimeError("the replicas' threads were stopped")
        futures = [pool.submit(self._call, i, fn, args[i], dtype)
                   for i, pool in enumerate(self._pools)]
        wait(futures)
        return [f.result() for f in futures]


def text_batches(encoded: Sequence[np.ndarray], batch_size: int,
                 bucket: int = 16):
    """Yield ``(indices, text, lens)`` host batches over encoded texts.

    ``encoded``: per-utterance int32 id arrays. Utterances are processed
    shortest-first; each batch is padded to the next ``bucket`` multiple
    of its longest member. The final batch is zero-padded up to
    ``batch_size`` rows (pad rows get ``lens == 1``) so the batch dim
    stays static; ``indices`` has only the real rows, in original input
    order positions.
    """
    batch_size = max(1, int(batch_size))
    order = sorted(range(len(encoded)), key=lambda j: len(encoded[j]))
    for s in range(0, len(order), batch_size):
        idxs: List[int] = order[s:s + batch_size]
        T = round_up(max(len(encoded[j]) for j in idxs), bucket)
        text = np.zeros((batch_size, T), np.int32)
        lens = np.ones((batch_size,), np.int32)
        for r, j in enumerate(idxs):
            text[r, :len(encoded[j])] = encoded[j]
            lens[r] = len(encoded[j])
        yield idxs, text, lens
