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

:func:`serve` is the text → mel → wav loop of every ``cli/*_infer.py``'s
``synthesize``: a family brings only its acoustic stage.
"""

from __future__ import annotations

import contextlib
import copy
import time
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from ..cli.hifigan_infer import vocode_replicas
from ..nn.precision import compute_dtype
from ..parallel.mesh import ServingReplica
from .device import resolve_devices
from .profiling import span

__all__ = ["round_up", "text_batches", "serving_sharding", "Replicas", "serve",
           "VOCODER_BUCKET"]

VOCODER_BUCKET = 128  # frames
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


def serve(model, generator, encoded: Sequence[np.ndarray], acoustic: Callable, *,
          device: Devices, batch_size: int = 8, dtype: Optional[torch.dtype] = None,
          acoustic_dtype: Optional[torch.dtype] = None, text_bucket: int = 16,
          frame_bucket: int = VOCODER_BUCKET, batch_inputs: Optional[Callable] = None,
          on_lengths: Optional[Callable] = None):
    """The serving loop. Yields ``(index, mel [n, n_mel], audio [n·hop] or
    None)`` per utterance, as f32 numpy, in batch order (``index``: its
    position in ``encoded``); a batch's utterances come before the next
    batch runs.

    ``model`` (a module or a tuple of them) and the vocoder ``generator``
    (or None) get one replica a device of ``device`` (one or a list), each
    batch split over them in contiguous rows (:func:`serving_sharding`).
    Text is padded to ``text_bucket`` tokens. ``acoustic(model_i, b, text,
    lens, *inputs)`` is the family's stage on batch ``b``'s rows of replica
    ``i``, computing in ``acoustic_dtype``: it returns the mels ``[rows, T,
    n_mel]`` and each row's frame count, on the device. ``batch_inputs(b,
    rows)`` gives the batch's further inputs at its whole shape, split as the
    text is (a draw taken once for the whole batch). ``on_lengths(lengths,
    seconds)`` sees the real rows' frame counts and the seconds from the
    batch's start to their host read. The vocoder, in ``dtype``, takes every
    replica's mels at the whole batch's longest count rounded up to
    ``frame_bucket`` frames (at most the ``T`` the acoustic stage padded
    to), and each utterance is trimmed to its count of frames and to that
    many times the vocoder's ``hop_size`` samples.

    With tracing on (``utils/profiling.py``) each batch is a ``serve.batch``
    span, closed before its utterances are yielded, holding each replica's
    ``serve.acoustic`` (device-timed), ``serve.wait`` (the host read of the
    lengths) and the vocoder stage's ``serve.vocoder`` and ``serve.to_host``.
    """
    devices = resolve_devices(device)
    put, replicate, batch_size = serving_sharding(batch_size, devices)
    models = replicate(model)
    generators = None if generator is None else replicate(generator)
    hop = 0 if generator is None else generator.config.hop_size

    with Replicas(devices) as replicas:
        for b, (idxs, text, lens) in enumerate(text_batches(encoded, batch_size, text_bucket)):
            t0 = time.perf_counter()

            def run(i, text, lens, *inputs):
                with span("serve.acoustic", text.device):
                    mel, n = acoustic(models[i], b, text, lens, *inputs)
                    # the host boundary is f32 whatever the compute type
                    mel = mel.float()
                with span("serve.wait"):
                    return mel, n.cpu().numpy()

            with span("serve.batch"):
                inputs = [] if batch_inputs is None else batch_inputs(b, len(text))
                mels, n = zip(*replicas.map(run, put(text), put(lens), *map(put, inputs),
                                            dtype=acoustic_dtype))
                n = np.concatenate(n)
                if on_lengths is not None:
                    on_lengths(n[:len(idxs)], time.perf_counter() - t0)
                frames = min(round_up(int(n[:len(idxs)].max()), frame_bucket), mels[0].shape[1])
                mel, audio = vocode_replicas(replicas, generators, mels, frames, dtype)
            for r, j in enumerate(idxs):
                k = int(n[r])
                yield j, mel[r, :k], (None if audio is None else audio[r, :k * hop])
