"""Grad-TTS — score-based diffusion text→mel: synthesis and training.

Counterpart of ``neuraltexttospeech_tpu/models/gradtts.py``: the config
(same defaults), ``fix_len_compatibility``, ``generate_path``,
``duration_loss``, the text encoder with windowed relative-position
attention, the 2-D UNet score estimator, ``get_noise``, the reverse SDE/ODE
Euler sampler (a loop over the steps), synthesis (``GradTTS.forward``) and
the training loss (``GradTTS.compute_loss``).

Layouts. The text encoder keeps JAX's ``[B, T, C]``. The UNet runs in
PyTorch's NCHW, ``[B, C, n_feats, T]``, where JAX's is NHWC ``[B, n_feats,
T, C]``; its input channels are ``[mu, x]`` (and the speaker's projection),
in JAX's order. Mels cross the module boundary as JAX's: the encoder's and
the decoder's ``[B, T_mel, n_feats]``.

Two convs of the UNet pad unlike PyTorch's defaults:

- the downsampling ``Conv((3, 3), strides=(2, 2), "SAME")`` pads ``(0, 1)``
  on an even axis (``(1, 1)`` on an odd one): an explicit ``F.pad``, then a
  conv with no padding (:func:`same_pad`);
- the upsampling ``ConvTranspose((4, 4), (2, 2), "SAME",
  transpose_kernel=True)`` is ``conv_transpose2d`` with stride 2 and
  padding 1, its flax kernel transposed (``convert.py``).

bf16 (``nn/precision.py``) follows flax's ``dtype=``: the convs, Dense
layers and norms compute in bf16, while the token and speaker embeddings
(``nn.Embed`` without ``dtype``), the relative-position tables (f32
parameters, so the attention's scores and weights are f32), GroupNorm's
statistics, the masks and the sampler's state stay f32, as JAX's type
promotion leaves them.

Randomness (the terminal noise, the stochastic sampler's per-step noise,
and in the loss the segment cut's ``u``, the diffusion time ``t`` and the
noise ``z``) comes in as arguments or from a ``torch.Generator``. Dropout
runs only when a call is given a generator for it (``nn/layers.py``);
synthesis gives none.

The loss aligns text and mel with MAS (``ops/mas.py``: the CUDA kernel on
the card) on the Gaussian log-prior, computed in f32 from ``mu_x`` and the
mel in every mode; the path is a constant for autograd. The random
``out_size`` segment is cut on the device by a gather at the offsets
``int(u · (max(ylen − out_size, 0) + 1))``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..nn.layers import (Conv2d, ConvNorm, ConvTranspose2d, GroupNorm, LayerNorm, Linear,
                         dropout)
from ..ops.mas import maximum_path
from ..parallel.mesh import global_count, global_draw
from ..utils.masking import mask_from_lens

__all__ = ["GradTTSConfig", "GradTTS", "TextEncoder", "GradLogPEstimator2D", "Diffusion",
           "fix_len_compatibility", "generate_path", "get_noise", "same_pad",
           "duration_loss", "gaussian_log_prior", "cut_offsets", "cut_segments"]

LN_EPS = 1e-4  # Grad-TTS's LayerNorm epsilon (not nn/layers.py's 1e-3)


@dataclasses.dataclass(frozen=True)
class GradTTSConfig:
    """Defaults = reference ``Grad-TTS_TF/params.py``."""

    n_symbols: int = 149            # len(symbols) + 1 blank (add_blank)
    n_feats: int = 80
    n_spks: int = 1
    spk_emb_dim: int = 64
    # encoder
    n_enc_channels: int = 192
    filter_channels: int = 768
    filter_channels_dp: int = 256
    n_enc_layers: int = 6
    enc_kernel: int = 3
    enc_dropout: float = 0.1
    n_heads: int = 2
    window_size: int = 4
    # decoder
    dec_dim: int = 64
    dim_mults: Tuple[int, ...] = (1, 2, 4)
    groups: int = 8
    groupnorm_epsilon: float = 1e-5
    beta_min: float = 0.05
    beta_max: float = 20.0
    pe_scale: float = 1000.0
    # training
    out_size: int = 172             # fix_len_compatibility(2*22050//256)
    learning_rate: float = 1e-4


def fix_len_compatibility(length: int, num_downsamplings: int = 2) -> int:
    """Round up to a multiple of 2^num_downsamplings
    (reference ``model/utils.py:16-20``)."""
    m = 2 ** num_downsamplings
    return ((length + m - 1) // m) * m


def generate_path(duration: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """durations [B, T_text] → hard alignment [B, T_text, T_mel] in
    ``mask``'s dtype (reference ``model/utils.py:28-44``: cumsum +
    sequence-mask difference)."""
    B, T_text, T_mel = mask.shape
    cum = torch.cumsum(duration, dim=1)
    path = mask_from_lens(cum.reshape(-1), T_mel).reshape(B, T_text, T_mel).to(mask.dtype)
    path = path - F.pad(path, (0, 0, 1, 0))[:, :-1]
    return path * mask


def duration_loss(logw: torch.Tensor, logw_hat: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
    """(reference ``model/utils.py:47-50``)."""
    return torch.sum(torch.square(logw - logw_hat)) / torch.clamp_min(
        global_count(torch.sum(lengths.float())), 1.0)


def gaussian_log_prior(mu_x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The unit-variance Gaussian log-likelihood of each mel frame under each
    token's ``mu``, [B, T_text, T_mel], in f32 whatever the inputs' type
    (reference ``tts.py:236-253``): ``-0.5 Σ_c y² + y·μ − 0.5 Σ_c μ² + const``,
    summed in JAX's order. mu_x [B, T_text, n_feats], y [B, T_mel, n_feats]."""
    const = -0.5 * math.log(2 * math.pi) * mu_x.shape[-1]
    mu_f, y_f = mu_x.float(), y.float()
    return (-0.5 * torch.sum(y_f ** 2, dim=-1)[:, None, :]
            + torch.matmul(mu_f, y_f.transpose(1, 2))
            - 0.5 * torch.sum(mu_f ** 2, dim=-1)[:, :, None]
            + const)


def cut_offsets(u: torch.Tensor, y_lengths: torch.Tensor, out_size: int) -> torch.Tensor:
    """Segment starts ``int(u · (max(ylen − out_size, 0) + 1))`` in f32, as
    JAX computes them (``tts.py:275-329``)."""
    max_offset = torch.clamp_min(y_lengths.long() - out_size, 0)
    return (u.float() * (max_offset + 1).float()).to(torch.int64)


def cut_segments(x: torch.Tensor, offsets: torch.Tensor, out_size: int,
                 dim: int) -> torch.Tensor:
    """``out_size`` steps of ``x`` along ``dim`` (1 or 2) from each row's
    offset, by a gather on the device; a start past ``T − out_size`` is
    clamped there, as ``lax.dynamic_slice`` clamps it."""
    T = x.shape[dim]
    start = torch.clamp(offsets, 0, T - out_size)
    idx = start[:, None] + torch.arange(out_size, device=x.device)      # [B, out_size]
    shape = [x.shape[0], 1, 1]
    shape[dim] = out_size
    idx = idx.reshape(shape)
    size = list(x.shape)
    size[dim] = out_size
    return torch.gather(x, dim, idx.expand(size))


def mish(x: torch.Tensor) -> torch.Tensor:
    """x · tanh(softplus(x)), as the JAX module writes it."""
    return x * torch.tanh(F.softplus(x))


def get_noise(t, beta_min: float, beta_max: float, cumulative: bool = False):
    """Linear β(t) (reference ``diffusion.py:294-299``)."""
    if cumulative:
        return beta_min * t + 0.5 * (beta_max - beta_min) * t ** 2
    return beta_min + (beta_max - beta_min) * t


def same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """flax/XLA ``padding="SAME"`` of the last two axes of an NCHW tensor for
    a strided conv: ``ceil(n / stride)`` outputs, the odd pad at the end."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


# ------------------------------------------------------------- text encoder

class ConvReluNormPrenet(nn.Module):
    """3×[conv5 → LayerNorm → ReLU → dropout] + a zero-initialised 1×1
    residual projection (reference ``text_encoder.py`` ConvReluNorm)."""

    def __init__(self, channels: int, kernel_size: int = 5, n_layers: int = 3,
                 p_dropout: float = 0.5):
        super().__init__()
        self.convs = nn.ModuleList(ConvNorm(channels, channels, kernel_size)
                                   for _ in range(n_layers))
        self.norms = nn.ModuleList(LayerNorm(channels, eps=LN_EPS) for _ in range(n_layers))
        self.proj = ConvNorm(channels, channels, 1)
        nn.init.zeros_(self.proj.weight)
        nn.init.zeros_(self.proj.bias)
        self.p_dropout = p_dropout

    def forward(self, x, mask, generator=None):
        m = mask[..., None].to(x.dtype)
        org = x
        for conv, norm in zip(self.convs, self.norms):
            x = dropout(torch.relu(norm(conv(x * m))), self.p_dropout, generator)
        return (org + self.proj(x)) * m


class RelPositionMultiHeadAttention(nn.Module):
    """Self-attention with windowed relative position embeddings (reference
    ``text_encoder.py:207-340``): offsets beyond ``±window_size`` contribute
    zero, not the edge embedding; the mask adds -1e4 to the scores in their
    dtype."""

    def __init__(self, channels: int, n_heads: int, window_size: int = 4,
                 p_dropout: float = 0.1):
        super().__init__()
        self.n_heads, self.window_size, self.p_dropout = n_heads, window_size, p_dropout
        k_ch = channels // n_heads
        self.conv_q = ConvNorm(channels, channels, 1)
        self.conv_k = ConvNorm(channels, channels, 1)
        self.conv_v = ConvNorm(channels, channels, 1)
        self.emb_rel_k = nn.Parameter(torch.randn(2 * window_size + 1, k_ch) * k_ch ** -0.5)
        self.emb_rel_v = nn.Parameter(torch.randn(2 * window_size + 1, k_ch) * k_ch ** -0.5)
        self.conv_o = ConvNorm(channels, channels, 1)

    def _band(self, T: int, device):
        """For each (query, relative offset r): the key position q + r - W
        (clamped into range) and whether it exists."""
        W = self.window_size
        key = torch.arange(T, device=device)[:, None] + torch.arange(-W, W + 1, device=device)
        return key.clamp(0, T - 1), (key >= 0) & (key < T)

    def forward(self, x, mask, generator=None):
        """x [B, T, C]; mask [B, T] bool."""
        B, T, C = x.shape
        H = self.n_heads
        heads = lambda y: y.view(B, T, H, C // H).transpose(1, 2)  # noqa: E731 [B, H, T, d]
        q, k, v = heads(self.conv_q(x)), heads(self.conv_k(x)), heads(self.conv_v(x))
        scale = 1.0 / math.sqrt(C // H)
        scores = torch.matmul(q, k.transpose(-1, -2)) * scale
        # relative logits: q · emb_rel_k[r] per offset r, placed on the band
        # |key - query| <= W; q takes the tables' type (f32), as JAX promotes
        key, valid = self._band(T, x.device)
        qk_rel = torch.matmul(q.to(torch.promote_types(q.dtype, self.emb_rel_k.dtype)),
                              self.emb_rel_k.t())                       # [B, H, T, 2W+1]
        rel = torch.zeros(B, H, T, T, dtype=qk_rel.dtype, device=x.device)
        rel.scatter_add_(-1, key.expand(B, H, T, -1), qk_rel * valid)
        scores = scores + rel * scale
        bias = torch.where(mask, 0.0, -1e4).to(scores.dtype)[:, None, None, :]
        p_attn = dropout(torch.softmax(scores + bias, dim=-1), self.p_dropout, generator)
        out = torch.matmul(p_attn, v.to(torch.promote_types(p_attn.dtype, v.dtype)))
        p_rel = torch.gather(p_attn, -1, key.expand(B, H, T, -1)) * valid   # [B, H, T, 2W+1]
        out = out + torch.matmul(p_rel, self.emb_rel_v.to(p_rel.dtype))
        return self.conv_o(out.transpose(1, 2).reshape(B, T, C))


class EncFFN(nn.Module):
    """conv(k) → ReLU → dropout → conv(k), masked (reference
    ``text_encoder.py:342-369``)."""

    def __init__(self, channels: int, filter_channels: int, kernel_size: int = 3,
                 p_dropout: float = 0.1):
        super().__init__()
        self.conv1 = ConvNorm(channels, filter_channels, kernel_size)
        self.conv2 = ConvNorm(filter_channels, channels, kernel_size)
        self.p_dropout = p_dropout

    def forward(self, x, mask, generator=None):
        m = mask[..., None].to(x.dtype)
        x = dropout(torch.relu(self.conv1(x * m)), self.p_dropout, generator)
        return self.conv2(x * m) * m


class DurationPredictor(nn.Module):
    """2×[conv3 → ReLU → LayerNorm → dropout] → 1×1 projection (reference
    ``text_encoder.py:112-142``). Returns [B, T, 1]."""

    def __init__(self, in_channels: int, filter_channels: int = 256, kernel_size: int = 3,
                 p_dropout: float = 0.1):
        super().__init__()
        self.convs = nn.ModuleList([ConvNorm(in_channels, filter_channels, kernel_size),
                                    ConvNorm(filter_channels, filter_channels, kernel_size)])
        self.norms = nn.ModuleList(LayerNorm(filter_channels, eps=LN_EPS) for _ in range(2))
        self.proj = ConvNorm(filter_channels, 1, 1)
        self.p_dropout = p_dropout

    def forward(self, x, mask, generator=None):
        m = mask[..., None].to(x.dtype)
        for conv, norm in zip(self.convs, self.norms):
            x = dropout(norm(torch.relu(conv(x * m))), self.p_dropout, generator)
        return self.proj(x * m) * m


class TextEncoder(nn.Module):
    """(reference ``text_encoder.py:422-501``). Returns ``(mu_x [B, T, n_feats],
    logw [B, T], mask [B, T])``."""

    def __init__(self, config: GradTTSConfig):
        super().__init__()
        c, C = config, config.n_enc_channels
        self.emb = nn.Embedding(c.n_symbols, C)  # flax Embed without dtype: f32 rows
        nn.init.normal_(self.emb.weight, 0.0, C ** -0.5)
        self.prenet = ConvReluNormPrenet(C)
        self.spk_proj = ConvNorm(C + c.spk_emb_dim, C, 1) if c.n_spks > 1 else None
        self.attn_layers = nn.ModuleList(
            RelPositionMultiHeadAttention(C, c.n_heads, c.window_size, c.enc_dropout)
            for _ in range(c.n_enc_layers))
        self.norms1 = nn.ModuleList(LayerNorm(C, eps=LN_EPS) for _ in range(c.n_enc_layers))
        self.ffn_layers = nn.ModuleList(
            EncFFN(C, c.filter_channels, c.enc_kernel, c.enc_dropout)
            for _ in range(c.n_enc_layers))
        self.norms2 = nn.ModuleList(LayerNorm(C, eps=LN_EPS) for _ in range(c.n_enc_layers))
        self.proj_m = ConvNorm(C, c.n_feats, 1)
        self.proj_w = DurationPredictor(C, c.filter_channels_dp)
        self.p_dropout = c.enc_dropout

    def forward(self, x, x_lengths, spk=None, generator=None):
        mask = mask_from_lens(x_lengths, x.shape[1])
        h = self.emb(x.long()) * math.sqrt(self.emb.embedding_dim)
        h = self.prenet(h, mask, generator)
        if spk is not None:
            h = self.spk_proj(torch.cat([h, spk[:, None, :].expand(-1, h.shape[1], -1)], -1))
        for attn, norm1, ffn, norm2 in zip(self.attn_layers, self.norms1, self.ffn_layers,
                                           self.norms2):
            h = norm1(h + dropout(attn(h, mask, generator), self.p_dropout, generator))
            h = norm2(h + dropout(ffn(h, mask, generator), self.p_dropout, generator))
        h = h * mask[..., None].to(h.dtype)
        mu_x = self.proj_m(h)
        mu_x = mu_x * mask[..., None].to(mu_x.dtype)
        logw = self.proj_w(h.detach(), mask, generator)[..., 0]
        return mu_x, logw, mask


# ---------------------------------------------------------------- UNet score

class UNetBlock(nn.Module):
    """conv3×3 → GroupNorm → Mish, masked (reference ``diffusion.py:57-69``)."""

    def __init__(self, dim_in: int, dim_out: int, groups: int = 8, eps: float = 1e-5):
        super().__init__()
        self.conv = Conv2d(dim_in, dim_out, 3, padding=1)
        self.norm = GroupNorm(groups, dim_out, eps=eps)

    def forward(self, x, mask):
        return mish(self.norm(self.conv(x * mask))) * mask


class UNetResnetBlock(nn.Module):
    """(reference ``diffusion.py:72-99``)."""

    def __init__(self, dim_in: int, dim_out: int, time_dim: int, groups: int = 8,
                 eps: float = 1e-5):
        super().__init__()
        self.block1 = UNetBlock(dim_in, dim_out, groups, eps)
        self.mlp = Linear(time_dim, dim_out)
        self.block2 = UNetBlock(dim_out, dim_out, groups, eps)
        self.res_conv = Conv2d(dim_in, dim_out, 1) if dim_in != dim_out else None

    def forward(self, x, mask, time_emb):
        h = self.block1(x, mask) + self.mlp(mish(time_emb))[:, :, None, None]
        h = self.block2(h, mask)
        return h + (self.res_conv(x * mask) if self.res_conv is not None else x * mask)


class LinearAttention2D(nn.Module):
    """kv-context linear attention (reference ``diffusion.py:102-148``): the
    1×1 qkv conv's channels are q, k, v blocks of ``heads · dim_head``; k's
    softmax runs over positions; q is not scaled."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.to_qkv = Conv2d(dim, 3 * heads * dim_head, 1, bias=False)
        self.to_out = Conv2d(heads * dim_head, dim, 1)

    def forward(self, x):
        B, _, Hh, Ww = x.shape
        q, k, v = self.to_qkv(x).reshape(B, 3, self.heads, self.dim_head, Hh * Ww).unbind(1)
        k = torch.softmax(k, dim=-1)
        context = torch.matmul(k, v.transpose(-1, -2))              # [B, h, d, e]
        out = torch.matmul(context.transpose(-1, -2), q)            # [B, h, e, n]
        return self.to_out(out.reshape(B, self.heads * self.dim_head, Hh, Ww))


class ReZeroAttention(nn.Module):
    """x + g·attn(x), g zero-initialised (reference ``diffusion.py:46-53,151-158``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.zeros(1))
        self.attn = LinearAttention2D(dim)

    def forward(self, x):
        return x + self.g * self.attn(x)


class GradLogPEstimator2D(nn.Module):
    """UNet over the stacked ``[mu, x]`` channels (reference
    ``diffusion.py:177-291``): x, mu [B, n_feats, T], mask [B, T] (T a
    multiple of 4, ``fix_len_compatibility``), t [B] → score [B, n_feats, T]."""

    def __init__(self, config: GradTTSConfig):
        super().__init__()
        self.config = c = config
        dim, groups, eps = c.dec_dim, c.groups, c.groupnorm_epsilon
        self.time_mlp1, self.time_mlp2 = Linear(dim, dim * 4), Linear(dim * 4, dim)
        self.spk_mlp = (nn.ModuleList([Linear(c.spk_emb_dim, c.spk_emb_dim * 4),
                                       Linear(c.spk_emb_dim * 4, c.n_feats)])
                        if c.n_spks > 1 else None)
        dims = [dim * m for m in c.dim_mults]
        ch = 3 if c.n_spks > 1 else 2
        self.downs = nn.ModuleList()
        for i, d in enumerate(dims):
            self.downs.append(nn.ModuleList([
                UNetResnetBlock(ch, d, dim, groups, eps), UNetResnetBlock(d, d, dim, groups, eps),
                ReZeroAttention(d)]
                + ([Conv2d(d, d, 3, stride=2)] if i < len(dims) - 1 else [])))
            ch = d
        self.mid = nn.ModuleList([UNetResnetBlock(ch, ch, dim, groups, eps), ReZeroAttention(ch),
                                  UNetResnetBlock(ch, ch, dim, groups, eps)])
        self.ups = nn.ModuleList()
        for i, d in enumerate(reversed(dims[:-1])):
            skip = dims[-1 - i]
            self.ups.append(nn.ModuleList([
                UNetResnetBlock(ch + skip, d, dim, groups, eps),
                UNetResnetBlock(d, d, dim, groups, eps), ReZeroAttention(d),
                ConvTranspose2d(d, d, 4, stride=2, padding=1)]))
            ch = d
        self.final_block = UNetBlock(ch, dim, groups, eps)
        self.final_conv = Conv2d(dim, 1, 1)

    def forward(self, x, mask, mu, t, spk=None):
        c = self.config
        half = c.dec_dim // 2
        freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=x.device)
                          * -(math.log(10000.0) / (half - 1)))
        te = c.pe_scale * t.float()[:, None] * freqs[None, :]
        temb = self.time_mlp2(mish(self.time_mlp1(torch.cat([torch.sin(te), torch.cos(te)], -1))))

        feats = [mu, x]
        if spk is not None:
            s = self.spk_mlp[1](mish(self.spk_mlp[0](spk)))
            feats.append(s[:, :, None].expand_as(mu))
        h = torch.stack(feats, dim=1)                    # [B, 2(+1), n_feats, T]
        masks = [mask[:, None, None, :].to(h.dtype)]     # [B, 1, 1, T]
        hiddens = []
        for level in self.downs:
            res1, res2, attn = level[:3]
            h = attn(res2(res1(h, masks[-1], temb), masks[-1], temb))
            hiddens.append(h)
            if len(level) == 4:
                h = level[3](same_pad(h * masks[-1], 3, 2))
                masks.append(masks[-1][..., ::2])
        res1, attn, res2 = self.mid
        h = res2(attn(res1(h, masks[-1], temb)), masks[-1], temb)
        for i, (res1, res2, attn, up) in enumerate(self.ups):
            mk = masks[-(i + 1)]
            h = torch.cat([h, hiddens[-(i + 1)]], dim=1)
            h = attn(res2(res1(h, mk, temb), mk, temb))
            h = up(h * mk)
        h = self.final_block(h, masks[0])
        return (self.final_conv(h * masks[0]) * masks[0])[:, 0]


class Diffusion(nn.Module):
    """The forward and reverse SDE of the score estimator and its loss
    (reference ``diffusion.py:302-383``)."""

    def __init__(self, config: GradTTSConfig):
        super().__init__()
        self.config = config
        self.estimator = GradLogPEstimator2D(config)

    @torch.no_grad()
    def reverse_diffusion(self, z, mask, mu, n_timesteps: int, stoc: bool = False, spk=None,
                          generator: Optional[torch.Generator] = None,
                          noise: Optional[Sequence[torch.Tensor]] = None):
        """Euler solver over ``n_timesteps`` (reference ``diffusion.py:333-358``):
        z, mu [B, n_feats, T], mask [B, T]. With ``stoc`` each step adds
        noise: ``noise[i]`` [B, n_feats, T], else drawn from ``generator``."""
        c = self.config
        h = 1.0 / n_timesteps
        m = mask[:, None, :].to(z.dtype)
        xt = z * m
        for i in range(n_timesteps):
            # JAX's f32 arithmetic: (1 - (i + 0.5) h) with i an f32 step index
            step = torch.full((z.shape[0],), float(i), dtype=torch.float32, device=z.device)
            t = 1.0 - (step + 0.5) * h
            noise_t = get_noise(t[:, None, None], c.beta_min, c.beta_max)
            score = self.estimator(xt, mask, mu, t, spk)
            if stoc:
                dxt_det = (0.5 * (mu - xt) - score) * noise_t * h
                zi = (noise[i] if noise is not None
                      else global_draw(torch.randn, z.shape, generator, device=z.device))
                dxt = dxt_det + zi * torch.sqrt(noise_t * h)
            else:
                dxt = 0.5 * (mu - xt - score) * noise_t * h
            xt = (xt - dxt) * m
        return xt

    def forward_diffusion(self, x0, mask, mu, t, z):
        """``x_t`` of the forward SDE at times ``t`` [B] with noise ``z``
        [B, n_feats, T]: ``(x_t, z)``, both masked."""
        c = self.config
        cum = get_noise(t[:, None, None], c.beta_min, c.beta_max, cumulative=True)
        mean = x0 * torch.exp(-0.5 * cum) + mu * (1.0 - torch.exp(-0.5 * cum))
        variance = 1.0 - torch.exp(-cum)
        xt = mean + z * torch.sqrt(variance)
        m = mask[:, None, :].to(x0.dtype)
        return xt * m, z * m

    def loss_t(self, x0, mask, mu, t, z, spk=None):
        """The score-matching loss at times ``t`` with noise ``z``:
        ``(loss, x_t)``."""
        c = self.config
        xt, z = self.forward_diffusion(x0, mask, mu, t, z)
        cum = get_noise(t[:, None, None], c.beta_min, c.beta_max, cumulative=True)
        est = self.estimator(xt, mask, mu, t, spk)
        est = est * torch.sqrt(1.0 - torch.exp(-cum))
        loss = torch.sum(torch.square(est + z)) / (
            torch.clamp_min(global_count(torch.sum(mask.float())), 1.0) * c.n_feats)
        return loss, xt

    def compute_loss(self, x0, mask, mu, spk=None, offset: float = 1e-5,
                     t: Optional[torch.Tensor] = None, z: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None):
        """:meth:`loss_t` at ``t`` ~ U[offset, 1 − offset) and ``z`` ~ N(0, 1),
        each drawn from ``generator`` unless given."""
        if t is None:
            t = global_draw(torch.rand, (x0.shape[0],), generator, device=x0.device)
            t = torch.clamp_min(t * (1.0 - 2 * offset) + offset, offset)
        if z is None:
            z = global_draw(torch.randn, x0.shape, generator, device=x0.device)
        return self.loss_t(x0, mask, mu, t.float(), z.float(), spk)


class GradTTS(nn.Module):
    """The model (reference ``model/tts.py``): synthesis (:meth:`forward`)
    and the training loss (:meth:`compute_loss`)."""

    def __init__(self, config: GradTTSConfig = GradTTSConfig()):
        super().__init__()
        self.config = config
        self.encoder = TextEncoder(config)
        self.decoder = Diffusion(config)
        self.spk_emb = nn.Embedding(config.n_spks, config.spk_emb_dim) if config.n_spks > 1 \
            else None

    def _spk(self, spk):
        return self.spk_emb(spk.long()) if self.spk_emb is not None and spk is not None else None

    @torch.no_grad()
    def forward(self, x, x_lengths, n_timesteps: int, temperature: float = 1.0,
                stoc: bool = False, spk=None, length_scale: float = 1.0,
                max_mel_len: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None,
                step_noise: Optional[Sequence[torch.Tensor]] = None):
        """Synthesis (reference ``tts.py:62-157``): text [B, T_text] → (encoder
        mel [B, T_mel, n_feats], decoder mel [B, T_mel, n_feats], alignment
        [B, T_text, T_mel], mel lengths [B] int32), ``T_mel`` the padded
        ``max_mel_len``.

        ``noise`` [B, n_feats, T_mel] fixes the terminal latent's noise term
        (``z = mu_y + noise / temperature``) and ``step_noise`` the
        stochastic sampler's; both are drawn from ``generator`` otherwise."""
        spk_v = self._spk(spk)
        mu_x, logw, x_mask = self.encoder(x, x_lengths, spk_v)

        w = torch.exp(logw) * x_mask.to(logw.dtype)
        w_ceil = torch.ceil(w) * length_scale
        y_lengths = torch.clamp(torch.sum(w_ceil, dim=1), min=1.0).to(torch.int32)
        if max_mel_len is None:
            max_mel_len = fix_len_compatibility(int(x.shape[1]) * 12)
        max_mel_len = fix_len_compatibility(max_mel_len)
        y_lengths = torch.clamp(y_lengths, max=max_mel_len)
        y_mask = mask_from_lens(y_lengths, max_mel_len)

        attn_mask = x_mask[:, :, None] & y_mask[:, None, :]
        attn = generate_path(w_ceil, attn_mask.float())
        mu_y = torch.matmul(attn.transpose(1, 2), mu_x.to(attn.dtype))   # [B, T_mel, n_feats]
        mu_y_t = mu_y.transpose(1, 2)
        if noise is None:
            noise = global_draw(torch.randn, mu_y_t.shape, generator, device=mu_y_t.device)
        z = mu_y_t + noise / temperature
        dec = self.decoder.reverse_diffusion(z, y_mask, mu_y_t, n_timesteps, stoc, spk_v,
                                             generator=generator, noise=step_noise)
        return mu_y, dec.transpose(1, 2), attn, y_lengths

    def compute_loss(self, x, x_lengths, y, y_lengths, spk=None,
                     out_size: Optional[int] = None,
                     generator: Optional[torch.Generator] = None,
                     u: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None,
                     z: Optional[torch.Tensor] = None):
        """``(dur_loss, prior_loss, diff_loss)`` (reference ``tts.py:193-356``).

        x [B, T_text] ids, y [B, T_mel, n_feats] mels (T_mel a multiple of 4
        when there is no cut). ``generator`` turns dropout on and draws what
        is not given: the cut's ``u`` [B] (used only when ``out_size <
        T_mel``), the diffusion time ``t`` [B] and the noise ``z`` [B,
        n_feats, min(out_size, T_mel)].
        """
        c = self.config
        spk_v = self._spk(spk)
        mu_x, logw, x_mask = self.encoder(x, x_lengths, spk_v, generator=generator)
        y_mask = mask_from_lens(y_lengths, y.shape[1])

        log_prior = gaussian_log_prior(mu_x.detach(), y)
        attn = maximum_path(log_prior.transpose(1, 2), x_lengths, y_lengths)
        attn = attn.transpose(1, 2).detach()                  # [B, T_text, T_mel]

        logw_hat = torch.log(1e-8 + torch.sum(attn, dim=-1)) * x_mask
        dur_loss = duration_loss(logw, logw_hat, x_lengths)

        if out_size is not None and out_size < y.shape[1]:
            if u is None:
                u = global_draw(torch.rand, (y.shape[0],), generator, device=y.device)
            offsets = cut_offsets(u, y_lengths, out_size)
            y = cut_segments(y, offsets, out_size, dim=1)
            attn = cut_segments(attn, offsets, out_size, dim=2)
            y_lengths = torch.clamp(y_lengths.long() - offsets, max=out_size)
            y_mask = mask_from_lens(y_lengths, out_size)

        mu_y = torch.matmul(attn.transpose(1, 2), mu_x.to(attn.dtype))   # [B, T_mel, n_feats]
        diff_loss, _ = self.decoder.compute_loss(y.transpose(1, 2), y_mask,
                                                 mu_y.transpose(1, 2), spk_v, t=t, z=z,
                                                 generator=generator)
        m = y_mask[:, :, None].float()
        prior_loss = torch.sum(0.5 * (torch.square(y - mu_y) + math.log(2 * math.pi)) * m)
        prior_loss = prior_loss / (torch.clamp_min(global_count(torch.sum(m)), 1.0) * c.n_feats)
        return dur_loss, prior_loss, diff_loss
