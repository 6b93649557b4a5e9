"""HiFi-GAN vocoder — generator, MPD/MSD discriminators, GAN losses.

Counterpart of ``neuraltexttospeech_tpu/models/hifigan.py`` (config v1/v2/v3,
``ResBlock1``, ``ResBlock2``, ``Generator``, ``DiscriminatorP``,
``MultiPeriodDiscriminator``, ``DiscriminatorS``, ``MultiScaleDiscriminator``
and the three losses). The generator runs plain ``conv1d`` /
``conv_transpose1d``: the JAX ``folded_convs`` path is a TPU lane-filling
rewrite of the same math and params and is not ported. For serving, weight
norm is folded into plain weights (``convert.py``); for training it is a
parametrization (``Generator(config, weight_norm=True)``, ``nn/norms.py``).

The MSD's grouped convs take the gouter path (``nn/fastconv.py``, kernel B2)
or plain grouped ``conv1d`` (``fast_grouped_convs`` picks, see
:func:`resolve_msd_group_impl`). Padding is flax's SAME throughout: with a
stride it is asymmetric, so every conv pads with ``F.pad`` first.

Modules take and return ``[B, T, C]`` like the JAX ones; inside, activations
are ``[B, C, T]`` (or the gouter layout). Which layout they lie in follows
the convs (``nn/layers.py``): the generator starts from the ``[B, C, T]``
view of its contiguous mel, so in bf16 on a card every one of its convs,
the transposed ones too, runs channels-last (cuDNN's bf16 NHWC engines, no
transpose) and its activations stay channels-last through the leaky ReLUs,
residual adds and block means; in f32 (training, TF32 off: cuDNN's NCHW
engines) and on the CPU they are contiguous ``[B, C, T]`` after the first
conv. The discriminators' convs run on contiguous ``[B, C, T]``, but for
the MPD's first in bf16 on a card: its one input channel makes the two
layouts one, and it runs channels-last.
Feature maps are returned in whatever layout the layer produced (the MSD's
folded layers in ``[g, B, Q, Po*co]``, the MPD's as ``[B*period, C, T/period]``):
:func:`feature_loss` does not depend on the order of elements.

Every conv computes in the compute dtype of ``nn/precision.py`` (bf16 under
``--amp``, as the JAX modules' ``dtype``), on f32 weight-normed or
spectral-normed weights; activations, feature maps and scores then come out
in that type, and the losses keep it, as JAX's do.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import torch
from torch import nn
from torch.nn import functional as F

from ..nn import fastconv
from ..nn.layers import Conv1d, ConvTranspose1d, promoted_conv, same_padding
from ..nn.norms import SpectralNorm
from ..nn.norms import weight_norm as _weight_norm
from ..parallel.mesh import global_mean
from ..utils import graphs

__all__ = ["HiFiGANConfig", "Generator", "ResBlock1", "ResBlock2",
           "transpose_padding", "DiscriminatorP", "MultiPeriodDiscriminator",
           "DiscriminatorS", "MultiScaleDiscriminator", "resolve_msd_group_impl",
           "feature_loss", "discriminator_loss", "generator_loss"]

LRELU_SLOPE = 0.1


@dataclasses.dataclass(frozen=True)
class HiFiGANConfig:
    """Generator, audio and training settings of ``HiFiGAN_TF/config_v{1,2,3}.json``."""

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
    segment_size: int = 8192
    fmax_for_loss: Optional[float] = None
    # training (reference config_v1.json)
    learning_rate: float = 2e-4
    adam_b1: float = 0.8
    adam_b2: float = 0.99
    lr_decay: float = 0.999
    seed: int = 1234
    batch_size: int = 16
    # MSD grouped convs: None, "gdot" or "gdot_pallas" = the gouter path
    # through kernel B2; False or "stock" = plain grouped conv1d
    fast_grouped_convs: Optional[Union[bool, str]] = None

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
          dilation: int = 1) -> Conv1d:
    return Conv1d(channels_in, channels_out, kernel_size, dilation=dilation,
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
    """mel [B, T, num_mels] → waveform [B, T·prod(upsample_rates), 1], tanh.

    ``weight_norm=True`` (training) puts :class:`~..nn.norms.WeightNorm` on
    every conv, as flax's ``nn.WeightNorm`` wraps them; serving loads folded
    weights into the plain module."""

    def __init__(self, config: HiFiGANConfig = HiFiGANConfig(), weight_norm: bool = False):
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
            self.ups.append(ConvTranspose1d(ch, ch_out, k, stride=u,
                                               padding=transpose_padding(k, u)))
            ch = ch_out
            for kr, dil in zip(c.resblock_kernel_sizes, c.resblock_dilation_sizes):
                self.resblocks.append(block(ch, kr, tuple(dil)))
        self.conv_post = _conv(ch, 1, 7)
        if weight_norm:
            for m in list(self.modules()):
                if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
                    _weight_norm(m)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """On a card, in inference mode and eval mode, each shape is captured
        as a CUDA graph on its first call and replayed after that
        (``utils/graphs.py``); the output is a fresh tensor either way."""
        return graphs.run(self, self._forward, x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
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


# ------------------------------------------------------------ discriminators

def same_pad(x: torch.Tensor, kernel_size: int, stride: int = 1) -> torch.Tensor:
    """Zero-pad the last axis as flax ``padding="SAME"`` does: ``ceil(L/s)``
    outputs, ``total = max((out-1)*s + k - L, 0)``, ``total // 2`` in front."""
    length = x.shape[-1]
    out = -(-length // stride)
    total = max((out - 1) * stride + kernel_size - length, 0)
    return F.pad(x, (total // 2, total - total // 2))


def avg_pool_same(x: torch.Tensor) -> torch.Tensor:
    """flax ``avg_pool(x, (4,), (2,), "SAME")`` over the last axis; the padded
    zeros count in the mean."""
    return F.avg_pool1d(same_pad(x, 4, 2), 4, 2)


def resolve_msd_group_impl(fast_grouped_convs) -> str:
    """``"gouter"`` (None, ``"gdot"``, ``"gdot_pallas"``: folded grouped convs
    through kernel B2) or ``"stock"`` (False, ``"stock"``: plain grouped
    ``conv1d``). ``"folded"``, ``"bgc"`` and True are TPU lowerings of the
    same math and are not ported."""
    if fast_grouped_convs in (None, "gdot", "gdot_pallas"):
        return "gouter"
    if fast_grouped_convs is False or fast_grouped_convs == "stock":
        return "stock"
    if fast_grouped_convs is True or fast_grouped_convs in ("folded", "bgc"):
        raise NotImplementedError(
            f"fast_grouped_convs={fast_grouped_convs!r} is a TPU lowering of the same "
            "math (group-major folded conv or batch_group_count) and is not ported; "
            "use None/'gdot'/'gdot_pallas' (kernel B2) or 'stock'")
    raise ValueError(f"fast_grouped_convs must be None, a bool, or one of "
                     f"'gdot'/'gdot_pallas'/'folded'/'stock'/'bgc', got "
                     f"{fast_grouped_convs!r}")


class DiscriminatorP(nn.Module):
    """Period discriminator: reflect-pad to a multiple of the period, fold
    time into ``[B*period, 1, T/period]``, stacked 5-tap convs (the (5, 1)
    kernels of the JAX module) with flax SAME padding. x [B, T, 1] →
    (score [B, T'*period], fmaps)."""

    KERNEL_SIZE = 5
    STRIDES = (3, 3, 3, 3, 1)

    def __init__(self, period: int):
        super().__init__()
        self.period = period
        chans = (1, 32, 128, 512, 1024, 1024)
        self.convs = nn.ModuleList(
            _weight_norm(Conv1d(ci, co, self.KERNEL_SIZE, stride=st))
            for ci, co, st in zip(chans[:-1], chans[1:], self.STRIDES))
        self.conv_post = _weight_norm(Conv1d(1024, 1, 3))

    def forward(self, x: torch.Tensor):
        x = x[..., 0]
        b, t = x.shape
        p = self.period
        if t % p:
            x = F.pad(x[:, None], (0, p - t % p), mode="reflect")[:, 0]
            t = x.shape[1]
        x = x.reshape(b, t // p, p).transpose(1, 2).reshape(b * p, 1, t // p)
        fmap = []
        for conv, st in zip(self.convs, self.STRIDES):
            x = F.leaky_relu(conv(same_pad(x, self.KERNEL_SIZE, st)), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(same_pad(x, 3))
        fmap.append(x)
        return x.reshape(b, p, -1).transpose(1, 2).reshape(b, -1), fmap


class MultiPeriodDiscriminator(nn.Module):
    """Five period discriminators, periods 2/3/5/7/11."""

    PERIODS = (2, 3, 5, 7, 11)

    def __init__(self):
        super().__init__()
        self.discriminators = nn.ModuleList(DiscriminatorP(p) for p in self.PERIODS)

    def scores(self, x: torch.Tensor):
        """One input [B, T, 1] → (scores, fmaps), one entry per period."""
        outs = [d(x) for d in self.discriminators]
        return [o[0] for o in outs], [o[1] for o in outs]

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        (y_d_rs, fmap_rs), (y_d_gs, fmap_gs) = self.scores(y), self.scores(y_hat)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs


class DiscriminatorS(nn.Module):
    """Scale discriminator: a stack of grouped convs, spectral norm on the
    raw-scale instance and weight norm on the others.

    ``group_impl="gouter"`` runs each grouped layer that the fold schedule
    covers as a folded conv in group-outermost layout through kernel B2
    (``nn/fastconv.py``), with free reshapes between layers of equal group
    count; ``"stock"`` runs plain grouped ``conv1d``. Same params and math."""

    # (channels, kernel, stride, groups) — reference model.py:284-320.
    SPECS = ((128, 15, 1, 1), (128, 41, 2, 4), (256, 41, 2, 16),
             (512, 41, 4, 16), (1024, 41, 4, 16), (1024, 41, 1, 16),
             (1024, 5, 1, 1))

    @staticmethod
    def _folded_schedule(specs):
        """Per-layer ``(Pi, Po)`` folds, or None for unfolded (g=1) layers,
        planned backward so a layer's output fold equals the next layer's
        input fold where legal (``hifigan.py:293-334`` of the JAX package)."""
        sched = [None] * len(specs)
        nxt_pi = None
        for i in reversed(range(len(specs))):
            ch, k, s, g = specs[i]
            if g == 1:
                nxt_pi = None
                continue
            co_g = ch // g

            def inflation(po):
                pi = s * po
                pl = (k - 1 + 1 - s) // 2
                ms = [(s * r + j - pl) // pi for r in range(po) for j in range(k)]
                return (max(ms) - min(ms) + 1) * pi / k

            po = max(1, 128 // co_g)
            if nxt_pi is not None and 128 <= nxt_pi * co_g <= 512 and inflation(nxt_pi) <= 2.6:
                po = nxt_pi
            elif inflation(po) > 2.6:  # pragma: no cover - no spec hits this
                sched[i] = None
                nxt_pi = None
                continue
            sched[i] = (s * po, po)
            nxt_pi = s * po
            if i > 0 and specs[i - 1][3] != g:
                nxt_pi = None
        return sched

    def __init__(self, use_spectral_norm: bool = False, group_impl: str = "gouter",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if group_impl not in ("gouter", "stock"):
            raise ValueError(f"group_impl must be 'gouter' or 'stock', got {group_impl!r}")
        self.group_impl = group_impl
        self.use_spectral_norm = use_spectral_norm
        chans = (1,) + tuple(spec[0] for spec in self.SPECS)
        self.convs = nn.ModuleList(
            nn.Conv1d(ci, ch, k, stride=s, groups=g)
            for ci, (ch, k, s, g) in zip(chans, self.SPECS))
        self.conv_post = nn.Conv1d(1024, 1, 3)
        if use_spectral_norm:
            self.sn = nn.ModuleList(SpectralNorm(m.out_channels, generator)
                                    for m in list(self.convs) + [self.conv_post])
        else:
            for m in list(self.convs) + [self.conv_post]:
                _weight_norm(m)

    def _weight(self, i: int, conv: nn.Conv1d, update_stats: bool) -> torch.Tensor:
        if self.use_spectral_norm:
            return self.sn[i](conv.weight, update_stats)
        return conv.weight

    def layer_plan(self, length: int):
        """``[(spec, (Pi, Po) or None, input length)]`` for an input of
        ``length`` samples: which layers take the gouter path."""
        sched = (self._folded_schedule(self.SPECS) if self.group_impl == "gouter"
                 else [None] * len(self.SPECS))
        plan = []
        for (ch, k, s, g), use in zip(self.SPECS, sched):
            if use and (length % use[0] != 0 or use[0] == 1):
                use = None  # length not foldable at this Pi -> plain conv
            plan.append(((ch, k, s, g), use, length))
            length = -(-length // s)
        return plan

    def forward(self, x: torch.Tensor, update_stats: bool = False):
        """x [B, T, 1] → (score [B, T'], fmaps)."""
        batch = x.shape[0]
        x = x.transpose(1, 2)  # [B, 1, T]
        cur_po, cur_g = 1, 1
        fmap = []
        for i, (conv, ((ch, k, s, g), use, _)) in enumerate(
                zip(self.convs, self.layer_plan(x.shape[-1]))):
            w = self._weight(i, conv, update_stats)
            if use:
                pi, po = use
                x = (fastconv.fold_gouter(x.transpose(1, 2), pi, g) if x.ndim == 3
                     else fastconv.regroup_gouter(x, cur_po, cur_g, pi, g))
                x = fastconv.gouter_conv(x, w, conv.bias, groups=g, stride=s, fold=pi)
                cur_po, cur_g = po, g
            else:
                if x.ndim == 4:
                    x = fastconv.unfold_gouter(x, cur_po, cur_g).transpose(1, 2)
                    cur_po, cur_g = 1, 1
                x = promoted_conv(F.conv1d, same_pad(x, k, s), w, conv.bias, stride=s, groups=g)
            x = F.leaky_relu(x, LRELU_SLOPE)
            fmap.append(x)
        if x.ndim == 4:
            x = fastconv.unfold_gouter(x, cur_po, cur_g).transpose(1, 2)
        w = self._weight(len(self.convs), self.conv_post, update_stats)
        x = promoted_conv(F.conv1d, same_pad(x, 3), w, self.conv_post.bias)
        fmap.append(x)
        return x.reshape(batch, -1), fmap


class MultiScaleDiscriminator(nn.Module):
    """Three scale discriminators over average-pooled audio; the first has
    spectral norm."""

    def __init__(self, group_impl: str = "gouter", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.discriminators = nn.ModuleList(
            DiscriminatorS(use_spectral_norm=(i == 0), group_impl=group_impl,
                           generator=generator) for i in range(3))

    def scores(self, x: torch.Tensor, update_stats: bool = False):
        """One input [B, T, 1] → (scores, fmaps), one entry per scale."""
        scores, fmaps = [], []
        x = x.transpose(1, 2)  # [B, 1, T]
        for i, d in enumerate(self.discriminators):
            if i:
                x = avg_pool_same(x)
            s, f = d(x.transpose(1, 2), update_stats=update_stats)
            scores.append(s)
            fmaps.append(f)
        return scores, fmaps

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor, update_stats: bool = False):
        y_d_rs, fmap_rs = self.scores(y, update_stats)
        y_d_gs, fmap_gs = self.scores(y_hat, update_stats)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs


# ------------------------------------------------------------------- losses
# Reference ``HiFiGAN_TF/losses.py:8-44`` (LSGAN + feature matching).

def feature_loss(fmap_r: List[List[torch.Tensor]], fmap_g) -> torch.Tensor:
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for r, g in zip(dr, dg):
            loss = loss + global_mean(torch.abs(r - g))
    return loss * 2.0


def discriminator_loss(disc_real, disc_generated):
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(disc_real, disc_generated):
        r_loss = global_mean(torch.square(1.0 - dr))
        g_loss = global_mean(torch.square(dg))
        loss = loss + r_loss + g_loss
        r_losses.append(r_loss)
        g_losses.append(g_loss)
    return loss, r_losses, g_losses


def generator_loss(disc_outputs):
    loss = 0.0
    gen_losses = []
    for dg in disc_outputs:
        l_g = global_mean(torch.square(1.0 - dg))
        gen_losses.append(l_g)
        loss = loss + l_g
    return loss, gen_losses
