"""Shared micro-layers (counterpart of ``neuraltexttospeech_tpu/nn/layers.py``).

Activations are ``[batch, time, channels]`` at module boundaries, as in the
JAX package; each conv transposes to PyTorch's ``[batch, channels, time]``
inside. LayerNorm epsilon is 1e-3 (the TF default the reference uses), not
PyTorch's 1e-5.

Dropout is explicit, as flax's ``deterministic`` flag is: a module drops
only when its call is given a ``torch.Generator`` (the trainer's per-step
stream), and never otherwise, whatever the module's train/eval mode. The
masks are drawn with ``torch.rand`` from that generator (``F.dropout``
takes none). Under a data-parallel mesh (``parallel/mesh.py``) the mask is
drawn at the global batch shape and each rank keeps its rows, as JAX draws
one mask for the global batch; BatchNorm takes its statistics over the
global batch.

:class:`Conv1d`, :class:`ConvTranspose1d`, :class:`Conv2d`,
:class:`ConvTranspose2d`, :class:`Linear`, :class:`Embedding`,
:class:`LayerNorm` and :class:`GroupNorm` are PyTorch's modules (the same
parameters and state-dict keys) computing in the compute dtype of
``nn/precision.py`` as flax's ``dtype=`` does: the convs, Linear and
Embedding cast their input and parameters to it, the norms normalise in f32
and cast their output. Without a compute dtype they are PyTorch's modules
unchanged.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed.nn.functional as dist_nn
from torch import nn
from torch.nn import functional as F

from ..parallel.mesh import collective_mesh, global_draw
from .precision import current, promote

__all__ = ["Conv1d", "ConvTranspose1d", "Conv2d", "ConvTranspose2d", "Linear", "Embedding",
           "LayerNorm", "GroupNorm", "BatchNorm", "ConvNorm",
           "ConvReLUNorm", "LN_EPS", "same_padding", "dropout", "promoted_conv", "softmax"]

LN_EPS = 1e-3


def same_padding(kernel_size: int, dilation: int = 1) -> int:
    """Symmetric padding equal to flax ``padding="SAME"`` at stride 1; it
    exists for odd kernels only (asymmetric SAME is not ported)."""
    if kernel_size % 2 == 0:
        raise ValueError(f"SAME padding is symmetric only for odd kernels, got {kernel_size}")
    return dilation * (kernel_size - 1) // 2


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator] = None, *,
            model_axis: Optional[int] = None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability ``1 - p`` and
    scale it by ``1 / (1 - p)``. Without a generator (or at ``p == 0``) it
    returns ``x``. Under a mesh the mask is this rank's slice of the global
    one (``parallel.mesh.global_draw``): the batch is ``x``'s axis 0, and
    ``model_axis`` holds its heads when a tensor-parallel block splits them."""
    if generator is None or p == 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    keep = global_draw(torch.rand, x.shape, generator, model_axis=model_axis,
                       device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


def softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis: ``exp(x − max)`` in x's type
    (the max without gradient), divided by its sum taken in f32 and cast
    back (JAX sums bf16 in f32)."""
    e = torch.exp(x - x.amax(-1, keepdim=True).detach())
    return e / e.float().sum(-1, keepdim=True).to(e.dtype)


def promoted_conv(conv, x: torch.Tensor, weight: torch.Tensor, bias, *args, **kwargs):
    """``conv(x, weight, bias, *args, **kwargs)``, a PyTorch convolution, with
    the three cast to the compute dtype (:func:`~.precision.promote`).

    PyTorch's CPU (oneDNN) bf16 convolutions give wrong outputs at some
    shapes (kernel 8 with 8 input channels, strided kernel-8 convs of 16
    channels: off by the output's own size), so on the CPU a bf16 conv runs
    in f32 on the bf16 values and its output is rounded to bf16 once: each
    product is exact in f32 and the sum is f32, which is a bf16 conv with an
    f32 accumulator, the card's arithmetic. The bias is added after that
    rounding, in bf16, as PyTorch adds it after a cuDNN convolution and as
    flax's ``Conv`` adds it (``y += bias``). Its gradients are rounded to
    bf16 by the casts' backward, as a bf16 conv's are."""
    x, weight, bias = promote(x, weight, bias)
    if x.dtype != torch.bfloat16 or x.is_cuda:
        return conv(x, weight, bias, *args, **kwargs)
    y = conv(x.float(), weight.float(), None, *args, **kwargs).to(torch.bfloat16)
    return y if bias is None else y + bias.to(y.dtype).reshape((-1,) + (1,) * (y.dim() - 2))


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` in the compute dtype (flax ``Conv(dtype=)``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return promoted_conv(self._conv_forward, x, self.weight, self.bias)


class ConvTranspose1d(nn.ConvTranspose1d):
    """``nn.ConvTranspose1d`` in the compute dtype (no ``output_size``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return promoted_conv(F.conv_transpose1d, x, self.weight, self.bias, self.stride,
                             self.padding, self.output_padding, self.groups, self.dilation)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in the compute dtype (flax ``Conv(dtype=)`` in 2-D)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return promoted_conv(self._conv_forward, x, self.weight, self.bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` in the compute dtype (no ``output_size``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return promoted_conv(F.conv_transpose2d, x, self.weight, self.bias, self.stride,
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


class GroupNorm(nn.GroupNorm):
    """flax ``GroupNorm(dtype=)``: statistics, normalisation, scale and bias
    in f32, the output cast to the compute dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps)
        dtype = current()
        return y if dtype is None else y.to(dtype)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=m, epsilon=1e-5)`` over axis 1 of a
    ``[B, C, ...]`` input (flax's feature axis is the last; the port's convs
    keep channels at axis 1).

    In train mode (``self.training``) it normalises by the batch's statistics
    over every axis but 1, padded positions included (flax takes no mask
    here), computed in f32 as ``mean = E[x]`` and the biased ``var = max(E[x²]
    − E[x]², 0)`` (flax's ``use_fast_variance``), and updates the running
    buffers without gradient as flax's ``mutable=["batch_stats"]`` does:
    ``running = m·running + (1 − m)·batch`` (PyTorch's ``momentum`` is
    ``1 − m``, and its running variance is unbiased). In eval mode it
    normalises by the buffers. ``y = (x − mean)·(rsqrt(var + eps)·weight) +
    bias`` in f32, cast to the compute dtype when one is set. ``weight``,
    ``bias`` and the f32 buffers ``running_mean``/``running_var`` are flax's
    ``scale``, ``bias``, ``mean`` and ``var``.

    Under a data-parallel mesh the statistics are the global batch's (flax
    under pjit): the sums of ``x`` and ``x²`` are summed over the data group
    by a differentiable all-reduce, whose backward sums the gradients too,
    and divided by the global element count, so every rank holds the same
    statistics and buffers."""

    def __init__(self, num_features: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.training:
            dims = [d for d in range(x.dim()) if d != 1]
            xf = x.float()
            mesh = collective_mesh("BatchNorm's batch statistics")
            if mesh is None:
                mean, mean_sq = xf.mean(dims), (xf * xf).mean(dims)
            else:
                sums = dist_nn.all_reduce(torch.stack([xf.sum(dims), (xf * xf).sum(dims)]),
                                          group=mesh.data_group)
                n = float(x.numel() // x.shape[1] * mesh.n_data)  # equal shards
                mean, mean_sq = sums[0] / n, sums[1] / n
            var = torch.clamp_min(mean_sq - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean.reshape(shape)) * (torch.rsqrt(var + self.eps) * self.weight).reshape(shape)
        y = y + self.bias.reshape(shape)
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
