"""FastSpeech 2 — MFA-supervised parallel text→mel.

Counterpart of ``neuraltexttospeech_tpu/models/fastspeech2.py`` (:1-215):
the config (``FastSpeech2_TF/config/LJSpeech/model.yaml``'s defaults: 4 + 6
FFT layers at width 256, 2 heads, filter 1024 with kernels (9, 1)), the
three variance predictors (FastPitch's ``TemporalPredictor``), the
bucketized pitch and energy embeddings, FastPitch's length regulator, the
mel projection, the 5-conv LayerNorm postnet, and ``fastspeech2_loss``.

Two places keep JAX's types and numbers exactly:

- the bucket edges are the f32 values of ``jnp.linspace(lo, hi, n_bins −
  1)`` as JAX's jitted model computes them (:func:`bucket_edges`), and a
  value goes to the bin of ``searchsorted(side="left")``
  (``torch.bucketize(right=False)``);
- the pitch and energy embeddings are flax ``nn.Embed`` without ``dtype``,
  so they stay f32 under bf16 (``torch.nn.Embedding``, not
  ``nn/layers.py::Embedding``): the encoder's bf16 output plus them is f32
  up to the decoder's first Dense, as JAX promotes.

The postnet's LayerNorm epsilon is flax's default 1e-6. Dropout runs only
when a call is given a generator (``nn/layers.py``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..nn.layers import ConvNorm, LayerNorm, Linear, dropout
from ..nn.transformer import FFTransformer
from ..parallel.mesh import global_count
from ..utils.masking import mask_from_lens
from .fastpitch import TemporalPredictor, regulate_len

__all__ = ["FastSpeech2Config", "FastSpeech2", "FastSpeech2Output", "fastspeech2_loss",
           "bucket_edges"]

POSTNET_LN_EPS = 1e-6  # flax LayerNorm's default


@dataclasses.dataclass(frozen=True)
class FastSpeech2Config:
    """Defaults = ``FastSpeech2_TF/config/LJSpeech/model.yaml``."""

    n_symbols: int = 148
    padding_idx: int = 0
    n_mel_channels: int = 80
    encoder_layer: int = 4
    encoder_head: int = 2
    encoder_hidden: int = 256
    decoder_layer: int = 6
    decoder_head: int = 2
    decoder_hidden: int = 256
    conv_filter_size: int = 1024
    conv_kernel_size: Tuple[int, int] = (9, 1)
    encoder_dropout: float = 0.2
    decoder_dropout: float = 0.2
    variance_filter_size: int = 256
    variance_kernel_size: int = 3
    variance_dropout: float = 0.5
    n_bins: int = 256
    # dataset statistics (stats.json from preprocessing); normalized pitch
    # and energy are roughly standard-normal, so ±4σ default bounds
    pitch_min: float = -4.0
    pitch_max: float = 4.0
    energy_min: float = -4.0
    energy_max: float = 4.0
    max_seq_len: int = 1000
    postnet: bool = True
    postnet_dim: int = 512
    postnet_kernel: int = 5
    postnet_layers: int = 5


class FastSpeech2Output(NamedTuple):
    """The forward's outputs, in the JAX ``FastSpeech2Output``'s order."""

    mel_out: torch.Tensor                # [B, T_mel, n_mel]
    mel_postnet: Optional[torch.Tensor]  # [B, T_mel, n_mel]
    log_dur_pred: torch.Tensor           # [B, T_text]
    pitch_pred: torch.Tensor             # [B, T_text]
    energy_pred: torch.Tensor            # [B, T_text]
    dec_lens: torch.Tensor               # [B]
    dec_mask: torch.Tensor               # [B, T_mel] bool


@functools.lru_cache(maxsize=16)
def bucket_edges(lo: float, hi: float, n_edges: int) -> np.ndarray:
    """``jnp.linspace(lo, hi, n_edges)`` in f32, value for value, as XLA
    folds it when ``lo`` and ``hi`` are constants (the config's floats in
    the jitted model): with ``r = f32(1 / (n_edges − 1))`` the interior edges
    are ``lo·(1 − i·r) + i·(hi·r)``, each product and sum rounded to f32,
    then ``hi`` itself. (Eager JAX, and jitted JAX with ``lo``/``hi`` as
    arguments, fuse the last multiply-add and round once: up to 1 ulp off
    at a third of the edges.) Cached: callers must not write to it."""
    f32 = np.float32
    lo, hi = f32(lo), f32(hi)
    div = n_edges - 1
    r = f32(1) / f32(div)
    i = np.arange(div, dtype=f32)
    out = lo * (f32(1) - i * r) + i * (hi * r)
    return np.concatenate([out, [hi]]).astype(f32)


class Postnet(nn.Module):
    """5-conv residual refiner: conv(k) → LayerNorm (eps 1e-6) → tanh (all
    but the last) → dropout 0.5, over [B, T, n_mel]."""

    def __init__(self, config: FastSpeech2Config):
        super().__init__()
        c = config
        chans = [c.n_mel_channels] + [c.postnet_dim] * (c.postnet_layers - 1) + [c.n_mel_channels]
        self.convs = nn.ModuleList(ConvNorm(chans[i], chans[i + 1], c.postnet_kernel)
                                   for i in range(c.postnet_layers))
        self.norms = nn.ModuleList(LayerNorm(chans[i + 1], eps=POSTNET_LN_EPS)
                                   for i in range(c.postnet_layers))
        self.p_dropout = 0.5  # fixed in JAX's _Postnet

    def forward(self, x, generator: Optional[torch.Generator] = None):
        for i, (conv, norm) in enumerate(zip(self.convs, self.norms)):
            x = norm(conv(x))
            if i < len(self.convs) - 1:
                x = torch.tanh(x)
            x = dropout(x, self.p_dropout, generator)
        return x


class FastSpeech2(nn.Module):
    """FastSpeech 2 (JAX ``FastSpeech2``): teacher-forced when the targets are
    given (training), from its own predictions otherwise."""

    def __init__(self, config: FastSpeech2Config = FastSpeech2Config()):
        super().__init__()
        c = self.config = config
        ff = dict(d_inner=c.conv_filter_size, kernel_size=c.conv_kernel_size[0],
                  kernel_size_2=c.conv_kernel_size[1])
        self.encoder = FFTransformer(
            n_layer=c.encoder_layer, n_head=c.encoder_head, d_model=c.encoder_hidden,
            d_head=c.encoder_hidden // c.encoder_head, embed_input=True, n_emb=c.n_symbols,
            padding_idx=c.padding_idx, dropout=c.encoder_dropout, dropatt=c.encoder_dropout,
            **ff)
        self.decoder = FFTransformer(
            n_layer=c.decoder_layer, n_head=c.decoder_head, d_model=c.decoder_hidden,
            d_head=c.decoder_hidden // c.decoder_head, embed_input=False,
            dropout=c.decoder_dropout, dropatt=c.decoder_dropout, **ff)
        vp = dict(in_channels=c.encoder_hidden, filter_size=c.variance_filter_size,
                  kernel_size=c.variance_kernel_size, dropout=c.variance_dropout)
        self.duration_predictor = TemporalPredictor(**vp)
        self.pitch_predictor = TemporalPredictor(**vp)
        self.energy_predictor = TemporalPredictor(**vp)
        # flax nn.Embed without dtype: f32 rows in every mode
        self.pitch_embedding = nn.Embedding(c.n_bins, c.encoder_hidden)
        self.energy_embedding = nn.Embedding(c.n_bins, c.encoder_hidden)
        self.mel_linear = Linear(c.decoder_hidden, c.n_mel_channels)
        self.postnet = Postnet(c) if c.postnet else None

    def _bucketize(self, x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
        edges = torch.tensor(bucket_edges(float(lo), float(hi), self.config.n_bins - 1),
                             device=x.device)
        return torch.bucketize(x.float(), edges, right=False)

    def forward(self, text: torch.Tensor, input_lens: torch.Tensor, *, mel_max_len: int,
                dur_tgt=None, pitch_tgt=None, energy_tgt=None, p_control: float = 1.0,
                e_control: float = 1.0, d_control: float = 1.0,
                generator: Optional[torch.Generator] = None) -> FastSpeech2Output:
        """text [B, T_text] ids (0 = padding: the encoder's mask comes from
        the ids, so ``input_lens`` is accepted for the JAX signature and not
        read); dur_tgt [B, T_text] frame counts; pitch/energy_tgt [B, T_text]
        phoneme-level normalized values. ``generator`` turns dropout on."""
        c, g = self.config, generator
        enc_out, enc_mask = self.encoder(text, generator=g)

        log_dur_pred = self.duration_predictor(enc_out, enc_mask, g)[..., 0]
        pitch_pred = self.pitch_predictor(enc_out, enc_mask, g)[..., 0]
        energy_pred = self.energy_predictor(enc_out, enc_mask, g)[..., 0]

        pitch = pitch_tgt if pitch_tgt is not None else pitch_pred * p_control
        enc_out = enc_out + self.pitch_embedding(self._bucketize(pitch, c.pitch_min, c.pitch_max))
        energy = energy_tgt if energy_tgt is not None else energy_pred * e_control
        enc_out = enc_out + self.energy_embedding(
            self._bucketize(energy, c.energy_min, c.energy_max))

        if dur_tgt is not None:
            durations = dur_tgt.float()
        else:
            durations = torch.clamp_min(torch.round(torch.exp(log_dur_pred) - 1.0),
                                        0.0) * d_control
            durations = durations * enc_mask.to(durations.dtype)
        expanded, dec_lens = regulate_len(durations, enc_out, mel_max_len=mel_max_len)

        dec_out, dec_mask = self.decoder(expanded, seq_lens=dec_lens, generator=g)
        mel_out = self.mel_linear(dec_out)
        mel_postnet = None
        if self.postnet is not None:
            mel_postnet = mel_out + self.postnet(mel_out, g)
        return FastSpeech2Output(mel_out, mel_postnet, log_dur_pred, pitch_pred, energy_pred,
                                 dec_lens, dec_mask)


def _masked_mean(err: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """sum(err · m) over the count of ``m`` broadcast to ``err``'s shape
    (the global batch's count under a data-parallel mesh)."""
    err = err * m
    return torch.sum(err) / torch.clamp_min(global_count(torch.sum(m.expand_as(err))), 1.0)


def fastspeech2_loss(out: FastSpeech2Output, mel_tgt, dur_tgt, pitch_tgt, energy_tgt,
                     input_lens, output_lens):
    """Masked mel L1 (and the postnet's) + MSE on log-duration, pitch and
    energy (JAX :185-215): ``(total, {"mel_loss", "postnet_loss",
    "duration_loss", "pitch_loss", "energy_loss"})``."""
    src_mask = mask_from_lens(input_lens, dur_tgt.shape[1]).float()
    mel_mask = mask_from_lens(output_lens, mel_tgt.shape[1])[..., None].float()
    mel_loss = _masked_mean(torch.abs(out.mel_out - mel_tgt), mel_mask)
    postnet_loss = (_masked_mean(torch.abs(out.mel_postnet - mel_tgt), mel_mask)
                    if out.mel_postnet is not None
                    else torch.zeros((), device=mel_tgt.device))
    log_dur_tgt = torch.log(dur_tgt.float() + 1.0)
    dur_loss = _masked_mean(torch.square(out.log_dur_pred - log_dur_tgt), src_mask)
    pitch_loss = _masked_mean(torch.square(out.pitch_pred - pitch_tgt), src_mask)
    energy_loss = _masked_mean(torch.square(out.energy_pred - energy_tgt), src_mask)
    total = mel_loss + postnet_loss + dur_loss + pitch_loss + energy_loss
    return total, {"mel_loss": mel_loss, "postnet_loss": postnet_loss,
                   "duration_loss": dur_loss, "pitch_loss": pitch_loss,
                   "energy_loss": energy_loss}
