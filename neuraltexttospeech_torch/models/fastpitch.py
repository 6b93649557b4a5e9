"""FastPitch — parallel text→mel acoustic model, inference path.

Counterpart of ``neuraltexttospeech_tpu/models/fastpitch.py``: the config
(same defaults), ``regulate_len``, ``TemporalPredictor`` and
``FastPitch.infer``. The aligner (``ConvAttention``), ``average_pitch`` and
the training forward come with the training slice; the converter skips the
aligner's weights.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..nn.layers import ConvNorm, ConvReLUNorm
from ..nn.transformer import FFTransformer

__all__ = ["FastPitchConfig", "FastPitch", "TemporalPredictor", "regulate_len"]


@dataclasses.dataclass(frozen=True)
class FastPitchConfig:
    """Defaults = reference ``FastPitch_TF/arg_parser.py`` argument groups."""

    n_mel_channels: int = 80
    n_symbols: int = 148
    padding_idx: int = 0
    symbols_embedding_dim: int = 384
    # input FFT
    in_fft_n_layers: int = 6
    in_fft_n_heads: int = 1
    in_fft_d_head: int = 64
    in_fft_conv1d_kernel_size: int = 3
    in_fft_conv1d_filter_size: int = 1536
    p_in_fft_dropout: float = 0.1
    p_in_fft_dropatt: float = 0.1
    p_in_fft_dropemb: float = 0.0
    # output FFT
    out_fft_n_layers: int = 6
    out_fft_n_heads: int = 1
    out_fft_d_head: int = 64
    out_fft_conv1d_kernel_size: int = 3
    out_fft_conv1d_filter_size: int = 1536
    p_out_fft_dropout: float = 0.1
    p_out_fft_dropatt: float = 0.1
    p_out_fft_dropemb: float = 0.0
    # duration predictor
    dur_predictor_kernel_size: int = 3
    dur_predictor_filter_size: int = 256
    p_dur_predictor_dropout: float = 0.1
    dur_predictor_n_layers: int = 2
    # pitch predictor
    pitch_predictor_kernel_size: int = 3
    pitch_predictor_filter_size: int = 256
    p_pitch_predictor_dropout: float = 0.1
    pitch_predictor_n_layers: int = 2
    pitch_embedding_kernel_size: int = 3
    pitch_conditioning_formants: int = 1
    # energy
    energy_conditioning: bool = True
    energy_predictor_kernel_size: int = 3
    energy_predictor_filter_size: int = 256
    p_energy_predictor_dropout: float = 0.1
    energy_predictor_n_layers: int = 2
    energy_embedding_kernel_size: int = 3
    # speakers
    n_speakers: int = 1
    speaker_emb_weight: float = 1.0
    # attention
    n_attn_channels: int = 80


def regulate_len(durations: torch.Tensor, enc_out: torch.Tensor, pace: float = 1.0,
                 mel_max_len: int = 2048):
    """Expand per-symbol encodings to frames via a 0/1 selection matmul.

    The output is always ``[B, mel_max_len, C]``; the decoded lengths,
    ``sum(floor(d / pace + 0.5))`` clipped to ``mel_max_len``, are returned
    for masking.
    """
    reps = torch.floor(durations.float() / pace + 0.5).long()
    dec_lens = reps.sum(dim=1)
    reps_cumsum = F.pad(reps, (1, 0)).cumsum(dim=1).float()[:, None, :]  # [B, 1, T+1]
    rng = torch.arange(mel_max_len, device=enc_out.device, dtype=torch.float32)[None, :, None]
    mult = (reps_cumsum[:, :, :-1] <= rng) & (reps_cumsum[:, :, 1:] > rng)
    enc_rep = torch.matmul(mult.to(enc_out.dtype), enc_out)
    return enc_rep, torch.clamp(dec_lens, max=mel_max_len)


class TemporalPredictor(nn.Module):
    """Duration/pitch/energy predictor head: [B, T, C] -> [B, T, n_predictions]."""

    def __init__(self, in_channels: int, filter_size: int, kernel_size: int,
                 n_layers: int = 2, n_predictions: int = 1):
        super().__init__()
        self.layers = nn.ModuleList(
            ConvReLUNorm(in_channels if i == 0 else filter_size, filter_size, kernel_size)
            for i in range(n_layers))
        self.fc = nn.Linear(filter_size, n_predictions)

    def forward(self, enc_out: torch.Tensor, enc_mask: torch.Tensor) -> torch.Tensor:
        m = enc_mask[..., None].to(enc_out.dtype)
        out = enc_out * m
        for layer in self.layers:
            out = layer(out)
        return self.fc(out) * m


class FastPitch(nn.Module):
    """FastPitch (reference ``FastPitch_TF/model.py:124-410``), inference."""

    def __init__(self, config: FastPitchConfig = FastPitchConfig()):
        super().__init__()
        c = self.config = config
        d = c.symbols_embedding_dim
        self.encoder = FFTransformer(
            n_layer=c.in_fft_n_layers, n_head=c.in_fft_n_heads, d_model=d,
            d_head=c.in_fft_d_head, d_inner=c.in_fft_conv1d_filter_size,
            kernel_size=c.in_fft_conv1d_kernel_size, embed_input=True,
            n_emb=c.n_symbols, padding_idx=c.padding_idx)
        if c.n_speakers > 1:
            self.speaker_emb = nn.Embedding(c.n_speakers, d)
        self.duration_predictor = TemporalPredictor(
            d, c.dur_predictor_filter_size, c.dur_predictor_kernel_size,
            n_layers=c.dur_predictor_n_layers)
        self.decoder = FFTransformer(
            n_layer=c.out_fft_n_layers, n_head=c.out_fft_n_heads, d_model=d,
            d_head=c.out_fft_d_head, d_inner=c.out_fft_conv1d_filter_size,
            kernel_size=c.out_fft_conv1d_kernel_size, embed_input=False)
        self.pitch_predictor = TemporalPredictor(
            d, c.pitch_predictor_filter_size, c.pitch_predictor_kernel_size,
            n_layers=c.pitch_predictor_n_layers,
            n_predictions=c.pitch_conditioning_formants)
        self.pitch_emb = ConvNorm(c.pitch_conditioning_formants, d,
                                  c.pitch_embedding_kernel_size)
        if c.energy_conditioning:
            self.energy_predictor = TemporalPredictor(
                d, c.energy_predictor_filter_size, c.energy_predictor_kernel_size,
                n_layers=c.energy_predictor_n_layers)
            self.energy_emb = ConvNorm(1, d, c.energy_embedding_kernel_size)
        self.proj = nn.Linear(d, c.n_mel_channels)

    def _speaker_vec(self, speaker):
        c = self.config
        if c.n_speakers <= 1 or speaker is None:
            return None
        return self.speaker_emb(speaker)[:, None, :] * c.speaker_emb_weight

    def infer(self, text: torch.Tensor, input_lens: Optional[torch.Tensor] = None, *,
              pace: float = 1.0, max_mel_len: int = 2048, speaker=None,
              dur_tgt=None, pitch_tgt=None, energy_tgt=None,
              max_duration: float = 75.0, pitch_transform=None):
        """Predicted durations/pitch/energy drive synthesis.

        text: [B, T_text] ids, 0 = padding (the mask comes from the ids, so
        ``input_lens`` is accepted for the JAX signature and not read).
        Returns (mel_out [B, max_mel_len, n_mel], dec_lens [B], dur_pred
        [B, T_text], pitch_pred [B, n_formants, T_text]).
        """
        c = self.config
        enc_out, enc_mask = self.encoder(text, conditioning=self._speaker_vec(speaker))

        log_dur_pred = self.duration_predictor(enc_out, enc_mask)[..., 0]
        dur_pred = torch.clamp(torch.exp(log_dur_pred) - 1.0, 0.0, max_duration)
        if dur_tgt is not None:
            dur_pred = dur_tgt

        pitch_pred = self.pitch_predictor(enc_out, enc_mask).transpose(1, 2)
        if pitch_transform is not None:
            pitch_pred = pitch_transform(pitch_pred)
        pitch = pitch_pred if pitch_tgt is None else pitch_tgt
        enc_out = enc_out + self.pitch_emb(pitch.transpose(1, 2))

        if c.energy_conditioning:
            energy_pred = self.energy_predictor(enc_out, enc_mask)[..., 0]
            energy = energy_pred if energy_tgt is None else energy_tgt
            enc_out = enc_out + self.energy_emb(energy[..., None])

        len_regulated, dec_lens = regulate_len(dur_pred, enc_out, pace, max_mel_len)
        dec_out, _ = self.decoder(len_regulated, seq_lens=dec_lens)
        return self.proj(dec_out), dec_lens, dur_pred, pitch_pred
