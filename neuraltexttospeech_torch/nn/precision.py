"""The port's one bf16 mechanism: flax's ``dtype=`` with f32 parameters.

The JAX package's ``--amp`` builds every module with ``dtype=jnp.bfloat16``
and ``param_dtype`` f32: each Dense, Conv, ConvTranspose and Embed casts its
input and its f32 parameters to bf16 (flax ``promote_dtype``) and returns
bf16, LayerNorm takes its statistics in f32 and returns bf16, and everything
else computes in whatever type reaches it, so the places that JAX writes in
f32 (the aligner's distances and softmax, spectral norm's power iteration,
weight norm, the log-mel, the losses' targets) stay f32. Parameters,
gradients and optimizer state stay f32.

Here the same rule is set for a block of code with :func:`compute_dtype`
and applied by the port's layers (``nn/layers.py``, the MSD's functional
convs) through :func:`promote`; all other arithmetic follows PyTorch's type
promotion, which for bf16 and f32 is JAX's. Unlike ``torch.autocast``, whose
op lists differ between the CPU and CUDA (CUDA's runs ``sum``, ``exp``,
``softmax`` and ``layer_norm`` in f32, the CPU's ``reflection_pad`` and the
losses), this gives the same arithmetic on both devices, so the CPU tests
hold the card's semantics against JAX. With no compute dtype set (the
default) :func:`promote` changes nothing. With tracing on
(``utils/profiling.py``), or in a tally, it counts the tensors it casts,
``precision.casts``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

from ..utils import profiling

__all__ = ["compute_dtype", "current", "promote"]

_state = threading.local()


@contextlib.contextmanager
def compute_dtype(dtype: Optional[torch.dtype]):
    """Run the block with the port's layers computing in ``dtype`` (None:
    in the inputs' own type). Nests; the previous setting comes back after."""
    prev = current()
    _state.dtype = dtype
    try:
        yield
    finally:
        _state.dtype = prev


def current() -> Optional[torch.dtype]:
    """The compute dtype set by the innermost :func:`compute_dtype`, or None."""
    return getattr(_state, "dtype", None)


def promote(*tensors, memory_format: torch.memory_format = torch.preserve_format):
    """flax ``promote_dtype``: each tensor (None passes through) cast to the
    compute dtype, laid out in ``memory_format`` by the same copy, or
    returned as it is when none is set."""
    dtype = current()
    if dtype is None:
        return tensors
    if profiling.counting():
        profiling.count("precision.casts",
                        sum(t is not None and t.dtype != dtype for t in tensors))
    return tuple(None if t is None else t.to(dtype, memory_format=memory_format)
                 for t in tensors)
