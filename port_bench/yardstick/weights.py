"""Seeded weights, made on the device in one draw, shared by the program
and the reference.

:func:`make` takes a list of ``(name, shape)`` and draws one normal buffer
for all of them from a ``torch.Generator`` on the device (names in sorted
order, each leaf its own slice), then applies an init rule per name:

- ``random_init``: a copy of ``chip_smoke.py::random_init_`` (biases 0, 1-D
  leaves 1, 2-D embeddings N(0, 1), every other leaf N(0, 1/fan_in) with
  fan_in the size of one slice along dim 0);
- ``flax_init``: a copy of ``models/hifigan_gan.py::init_params_`` (biases
  0, weight-norm scales 1, every other leaf N(0, 1/fan_in)); a spectral-norm
  ``u`` buffer keeps its N(0, 1) draw.

The same seed gives the same weights on both sides; :func:`load` copies
them into a module by name and raises when the names or shapes differ.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import torch

__all__ = ["spec", "make", "load"]


def spec(module: torch.nn.Module, buffers: Iterable[str] = ()) -> List[Tuple[str, tuple]]:
    """``(name, shape)`` of every parameter and of the named buffers."""
    out = [(n, tuple(p.shape)) for n, p in module.named_parameters()]
    bufs = dict(module.named_buffers())
    out += [(n, tuple(bufs[n].shape)) for n in buffers]
    return sorted(out)


def _value(rule: str, name: str, shape: tuple, draw: torch.Tensor) -> torch.Tensor:
    if name.endswith("bias"):
        return torch.zeros(shape, device=draw.device)
    if rule == "flax_init" and name.endswith(".u"):
        return draw.view(shape)
    if rule == "flax_init" and name.endswith("original1"):
        return torch.ones(shape, device=draw.device)
    if rule == "random_init" and len(shape) == 1:
        return torch.ones(shape, device=draw.device)
    if rule == "random_init" and "emb" in name and len(shape) == 2:
        return draw.view(shape).clone()
    fan_in = 1
    for d in shape[1:]:
        fan_in *= d
    return draw.view(shape) * fan_in ** -0.5


def make(leaves: List[Tuple[str, tuple]], seed: int, device, rule: str) -> Dict[str, torch.Tensor]:
    """The seeded weights of ``leaves`` (f32, on ``device``)."""
    if rule not in ("random_init", "flax_init"):
        raise ValueError(f"unknown init rule {rule!r}")
    leaves = sorted(leaves)
    sizes = [int(torch.Size(s).numel()) for _, s in leaves]
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    flat = torch.empty(sum(sizes), device=device).normal_(generator=gen)
    out, offset = {}, 0
    for (name, shape), n in zip(leaves, sizes):
        out[name] = _value(rule, name, shape, flat[offset:offset + n])
        offset += n
    return out


@torch.no_grad()
def load(module: torch.nn.Module, weights: Dict[str, torch.Tensor]):
    """Copy ``weights`` into the module's parameters and buffers by name."""
    tensors = dict(module.named_parameters())
    tensors.update(module.named_buffers())
    missing = sorted(set(weights) - set(tensors))
    if missing:
        raise KeyError(f"{type(module).__name__} has no {missing[:4]}")
    for name, value in weights.items():
        if tuple(tensors[name].shape) != tuple(value.shape):
            raise ValueError(f"{name}: {tuple(tensors[name].shape)} against {tuple(value.shape)}")
        tensors[name].copy_(value)
    return module
