"""Device policy of the port's entry points.

Entry points run on the card unless the caller asks for the CPU. Without a
CUDA device, a call that did not ask for the CPU raises: nothing carries on
silently on the CPU. The serving CLIs spread their batches over every
visible card unless told otherwise (:func:`resolve_devices`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

__all__ = ["resolve_device", "resolve_devices"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``. Raises if a CUDA device is asked for and
    there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return device


def resolve_devices(device: Optional[Union[str, torch.device,
                                       Sequence[Union[str, torch.device]]]] = None
                    ) -> List[torch.device]:
    """The devices a serving loop spreads its batches over (counterpart of
    ``jax.devices()`` in the JAX package's ``utils/serving.py``).

    ``None`` means every visible CUDA device (``torch.cuda.device_count()``,
    which ``CUDA_VISIBLE_DEVICES`` restricts) and raises without one; a
    device (``"cpu"``, ``"cuda:1"``) means that one; a list means those, in
    its order. A CUDA device without an index gets the current one."""
    if device is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU")
        return [torch.device("cuda", i) for i in range(n)]
    if isinstance(device, (str, torch.device)):
        device = [device]
    devices = [resolve_device(d) for d in device]
    if not devices:
        raise ValueError("an empty list of devices")
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devices]
