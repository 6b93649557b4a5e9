"""Batched-serving helpers for the inference CLIs.

Counterpart of ``neuraltexttospeech_tpu/utils/serving.py``: length-sort the
utterances, batch them, and pad each batch to a coarse text-length bucket.
PyTorch runs eagerly, so the buckets no longer bound a compile count; they
are kept so the port serves the same padded shapes as the JAX CLI, which
the parity tests rely on.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

__all__ = ["round_up", "text_batches", "serving_sharding"]


def round_up(n: int, multiple: int) -> int:
    return -(-int(n) // multiple) * multiple


def serving_sharding(batch_size: int, device: torch.device):
    """One-device serving placement: ``(put, replicate, batch_size)``.

    ``put(x)`` moves a host batch to ``device``; ``replicate(module)`` moves
    a model there. Serving across several GPUs is a later slice.
    """
    batch_size = max(1, int(batch_size))
    return (lambda x: torch.as_tensor(np.asarray(x), device=device),
            lambda module: module.to(device),
            batch_size)


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
