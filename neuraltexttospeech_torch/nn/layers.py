"""Shared micro-layers (counterpart of ``neuraltexttospeech_tpu/nn/layers.py``).

Activations are ``[batch, time, channels]`` at module boundaries, as in the
JAX package; each conv transposes to PyTorch's ``[batch, channels, time]``
inside. LayerNorm epsilon is 1e-3 (the TF default the reference uses), not
PyTorch's 1e-5.

Dropout is explicit, as flax's ``deterministic`` flag is: a module drops
only when its call is given a ``torch.Generator`` (the trainer's per-step
stream), and never otherwise, whatever the module's train/eval mode. The
masks are drawn with ``torch.rand`` from that generator (``F.dropout``
takes none).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ["ConvNorm", "ConvReLUNorm", "LN_EPS", "same_padding", "dropout"]

LN_EPS = 1e-3


def same_padding(kernel_size: int, dilation: int = 1) -> int:
    """Symmetric padding equal to flax ``padding="SAME"`` at stride 1; it
    exists for odd kernels only (asymmetric SAME is not ported)."""
    if kernel_size % 2 == 0:
        raise ValueError(f"SAME padding is symmetric only for odd kernels, got {kernel_size}")
    return dilation * (kernel_size - 1) // 2


def dropout(x: torch.Tensor, p: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability ``1 - p`` and
    scale it by ``1 / (1 - p)``. Without a generator (or at ``p == 0``) it
    returns ``x``."""
    if generator is None or p == 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


class ConvNorm(nn.Conv1d):
    """1-D conv with SAME padding over ``[B, T, C]`` activations."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1,
                 dilation: int = 1, bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size, dilation=dilation,
                         padding=same_padding(kernel_size, dilation), bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


class ConvReLUNorm(nn.Module):
    """conv -> ReLU -> LayerNorm -> dropout."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1,
                 dropout: float = 0.0):
        super().__init__()
        self.conv = ConvNorm(in_channels, out_channels, kernel_size)
        self.norm = nn.LayerNorm(out_channels, eps=LN_EPS)
        self.p_dropout = dropout

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return dropout(self.norm(torch.relu(self.conv(x))), self.p_dropout, generator)
