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

:class:`Conv1d`, :class:`ConvTranspose1d`, :class:`Linear`,
:class:`Embedding` and :class:`LayerNorm` are PyTorch's modules (the same
parameters and state-dict keys) computing in the compute dtype of
``nn/precision.py`` as flax's ``dtype=`` does: the first four cast their
input and parameters to it, LayerNorm normalises in f32 and casts its
output. Without a compute dtype they are PyTorch's modules unchanged.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from .precision import current, promote

__all__ = ["Conv1d", "ConvTranspose1d", "Linear", "Embedding", "LayerNorm", "ConvNorm",
           "ConvReLUNorm", "LN_EPS", "same_padding", "dropout", "promoted_conv"]

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


def promoted_conv(conv, x: torch.Tensor, weight: torch.Tensor, bias, *args, **kwargs):
    """``conv(x, weight, bias, *args, **kwargs)``, a PyTorch convolution, with
    the three cast to the compute dtype (:func:`~.precision.promote`).

    PyTorch's CPU (oneDNN) bf16 convolutions give wrong outputs at some
    shapes (kernel 8 with 8 input channels, strided kernel-8 convs of 16
    channels: off by the output's own size), so on the CPU a bf16 conv runs
    in f32 on the bf16 values and its output is rounded to bf16 once: each
    product is exact in f32 and the sum is f32, which is a bf16 conv with an
    f32 accumulator, the card's arithmetic. Its gradients are rounded to
    bf16 by the casts' backward, as a bf16 conv's are."""
    x, weight, bias = promote(x, weight, bias)
    if x.dtype != torch.bfloat16 or x.is_cuda:
        return conv(x, weight, bias, *args, **kwargs)
    return conv(x.float(), weight.float(), None if bias is None else bias.float(),
                *args, **kwargs).to(torch.bfloat16)


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` in the compute dtype (flax ``Conv(dtype=)``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return promoted_conv(self._conv_forward, x, self.weight, self.bias)


class ConvTranspose1d(nn.ConvTranspose1d):
    """``nn.ConvTranspose1d`` in the compute dtype (no ``output_size``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return promoted_conv(F.conv_transpose1d, x, self.weight, self.bias, self.stride,
                             self.padding, self.output_padding, self.groups, self.dilation)


class Linear(nn.Linear):
    """``nn.Linear`` in the compute dtype (flax ``Dense(dtype=)``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(*promote(x, self.weight, self.bias))


class Embedding(nn.Embedding):
    """``nn.Embedding`` whose rows come out in the compute dtype (flax
    ``Embed(dtype=)``)."""

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        (weight,) = promote(self.weight)
        return F.embedding(ids, weight, self.padding_idx, self.max_norm, self.norm_type,
                           self.scale_grad_by_freq, self.sparse)


class LayerNorm(nn.LayerNorm):
    """flax ``LayerNorm(dtype=)``: statistics, normalisation, scale and bias
    in f32, the output cast to the compute dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        dtype = current()
        return y if dtype is None else y.to(dtype)


class ConvNorm(Conv1d):
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
        self.norm = LayerNorm(out_channels, eps=LN_EPS)
        self.p_dropout = dropout

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return dropout(self.norm(torch.relu(self.conv(x))), self.p_dropout, generator)
