"""HiFi-GAN generator — mel → waveform.

Counterpart of the generator half of ``neuraltexttospeech_tpu/models/hifigan.py``
(config v1/v2/v3, ``ResBlock1``, ``ResBlock2``, ``Generator``), with plain
``conv1d`` / ``conv_transpose1d``: the JAX ``folded_convs`` path is a TPU
lane-filling rewrite of the same math and params and is not ported. Weight
norm is folded into plain weights when a checkpoint is converted
(``convert.py``). The discriminators and losses come with the training slice.

The generator's input and output are ``[B, T, C]`` like the JAX module's;
inside, activations stay ``[B, C, T]`` so no conv pays a transpose.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..nn.layers import same_padding

__all__ = ["HiFiGANConfig", "Generator", "ResBlock1", "ResBlock2",
           "transpose_padding"]

LRELU_SLOPE = 0.1


@dataclasses.dataclass(frozen=True)
class HiFiGANConfig:
    """Generator and audio settings of ``HiFiGAN_TF/config_v{1,2,3}.json``;
    the training settings come with the training slice."""

    resblock: str = "1"
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5), (1, 3, 5), (1, 3, 5))
    num_mels: int = 80
    n_fft: int = 1024
    hop_size: int = 256
    win_size: int = 1024
    sampling_rate: int = 22050
    fmin: float = 0.0
    fmax: float = 8000.0

    @classmethod
    def v1(cls, **kw) -> "HiFiGANConfig":
        return cls(**kw)

    @classmethod
    def v2(cls, **kw) -> "HiFiGANConfig":
        return cls(resblock="1", upsample_rates=(8, 8, 2, 2),
                   upsample_kernel_sizes=(16, 16, 4, 4),
                   upsample_initial_channel=128,
                   resblock_kernel_sizes=(3, 7, 11),
                   resblock_dilation_sizes=((1, 3, 5), (1, 3, 5), (1, 3, 5)),
                   **kw)

    @classmethod
    def v3(cls, **kw) -> "HiFiGANConfig":
        return cls(resblock="2", upsample_rates=(8, 8, 4),
                   upsample_kernel_sizes=(16, 16, 8),
                   upsample_initial_channel=256,
                   resblock_kernel_sizes=(3, 5, 7),
                   resblock_dilation_sizes=((1, 2), (2, 6), (3, 12)),
                   **kw)

    @property
    def total_upsample(self) -> int:
        out = 1
        for u in self.upsample_rates:
            out *= u
        return out


def transpose_padding(kernel_size: int, stride: int) -> int:
    """``ConvTranspose1d`` padding equal to flax ``ConvTranspose(padding="SAME",
    transpose_kernel=True)``: flax pads the dilated input by
    ``pad_a = ceil((k + u - 2) / 2)`` in front (``k - 1`` when ``u > k - 1``),
    which is PyTorch's ``padding = k - 1 - pad_a = (k - u) / 2`` with no
    output padding. It exists when ``k - u`` is even and not negative."""
    if kernel_size < stride or (kernel_size - stride) % 2:
        raise ValueError(f"no symmetric SAME transpose padding for kernel "
                         f"{kernel_size}, stride {stride}")
    return (kernel_size - stride) // 2


def _conv(channels_in: int, channels_out: int, kernel_size: int,
          dilation: int = 1) -> nn.Conv1d:
    return nn.Conv1d(channels_in, channels_out, kernel_size, dilation=dilation,
                     padding=same_padding(kernel_size, dilation))


class ResBlock1(nn.Module):
    """MRF residual block, type 1: per dilation, LReLU → dilated conv →
    LReLU → conv, with a residual. [B, C, T] -> [B, C, T]."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Tuple[int, ...] = (1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList(_conv(channels, channels, kernel_size, d)
                                    for d in dilation)
        self.convs2 = nn.ModuleList(_conv(channels, channels, kernel_size)
                                    for _ in dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = c1(F.leaky_relu(x, LRELU_SLOPE))
            x = c2(F.leaky_relu(xt, LRELU_SLOPE)) + x
        return x


class ResBlock2(nn.Module):
    """MRF residual block, type 2: per dilation, LReLU → dilated conv, with a
    residual. [B, C, T] -> [B, C, T]."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Tuple[int, ...] = (1, 3)):
        super().__init__()
        self.convs = nn.ModuleList(_conv(channels, channels, kernel_size, d)
                                   for d in dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c in self.convs:
            x = c(F.leaky_relu(x, LRELU_SLOPE)) + x
        return x


class Generator(nn.Module):
    """mel [B, T, num_mels] → waveform [B, T·prod(upsample_rates), 1], tanh."""

    def __init__(self, config: HiFiGANConfig = HiFiGANConfig()):
        super().__init__()
        c = self.config = config
        block = ResBlock1 if c.resblock == "1" else ResBlock2
        self.num_kernels = len(c.resblock_kernel_sizes)
        self.conv_pre = _conv(c.num_mels, c.upsample_initial_channel, 7)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        ch = c.upsample_initial_channel
        for i, (u, k) in enumerate(zip(c.upsample_rates, c.upsample_kernel_sizes)):
            ch_out = c.upsample_initial_channel // (2 ** (i + 1))
            self.ups.append(nn.ConvTranspose1d(ch, ch_out, k, stride=u,
                                               padding=transpose_padding(k, u)))
            ch = ch_out
            for kr, dil in zip(c.resblock_kernel_sizes, c.resblock_dilation_sizes):
                self.resblocks.append(block(ch, kr, tuple(dil)))
        self.conv_post = _conv(ch, 1, 7)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_pre(x.transpose(1, 2))
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            blocks = self.resblocks[i * self.num_kernels:(i + 1) * self.num_kernels]
            xs = blocks[0](x)
            for block in blocks[1:]:
                xs = xs + block(x)
            x = xs / self.num_kernels
        x = self.conv_post(F.leaky_relu(x, 0.3))  # final LReLU: the Keras default slope
        return torch.tanh(x).transpose(1, 2)
