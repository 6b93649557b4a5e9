"""Shared micro-layers (counterpart of ``neuraltexttospeech_tpu/nn/layers.py``).

Activations are ``[batch, time, channels]`` at module boundaries, as in the
JAX package; each conv transposes to PyTorch's ``[batch, channels, time]``
inside. LayerNorm epsilon is 1e-3 (the TF default the reference uses), not
PyTorch's 1e-5.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["ConvNorm", "ConvReLUNorm", "LN_EPS", "same_padding"]

LN_EPS = 1e-3


def same_padding(kernel_size: int, dilation: int = 1) -> int:
    """Symmetric padding equal to flax ``padding="SAME"`` at stride 1; it
    exists for odd kernels only (asymmetric SAME is not ported)."""
    if kernel_size % 2 == 0:
        raise ValueError(f"SAME padding is symmetric only for odd kernels, got {kernel_size}")
    return dilation * (kernel_size - 1) // 2


class ConvNorm(nn.Conv1d):
    """1-D conv with SAME padding over ``[B, T, C]`` activations."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1,
                 dilation: int = 1, bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size, dilation=dilation,
                         padding=same_padding(kernel_size, dilation), bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


class ConvReLUNorm(nn.Module):
    """conv -> ReLU -> LayerNorm (dropout is off at inference)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1):
        super().__init__()
        self.conv = ConvNorm(in_channels, out_channels, kernel_size)
        self.norm = nn.LayerNorm(out_channels, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(torch.relu(self.conv(x)))
