"""FastPitch — parallel text→mel acoustic model.

Counterpart of ``neuraltexttospeech_tpu/models/fastpitch.py``: the config
(same defaults), ``regulate_len``, ``average_pitch``, ``TemporalPredictor``,
the aligner ``ConvAttention``, the training forward ``FastPitch.forward``
and ``FastPitch.infer``.

The training forward binarizes the aligner's soft attention with monotonic
alignment search on the device (``ops/mas.py``: the CUDA kernel on the
card), as a constant for autograd. Dropout runs only when the call is given
a generator (``nn/layers.py``); ``infer`` never drops.

A serving state dict may leave out the aligner (``attention.*``), which only
the training forward reads: :meth:`FastPitch.load_state_dict` then keeps
the aligner as initialised.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..nn.layers import ConvNorm, ConvReLUNorm, Linear
from ..nn.transformer import FFTransformer
from ..ops.mas import maximum_path
from ..utils import graphs
from ..utils.masking import mask_from_lens

__all__ = ["FastPitchConfig", "FastPitch", "FastPitchOutput", "ConvAttention",
           "TemporalPredictor", "regulate_len", "average_pitch"]

_NEG = -1e9


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


class FastPitchOutput(NamedTuple):
    """Training-forward outputs, in the JAX ``FastPitchOutput``'s order."""

    mel_out: torch.Tensor        # [B, T_mel, n_mel]
    dec_mask: torch.Tensor       # [B, T_mel] bool
    dur_pred: torch.Tensor       # [B, T_text]
    log_dur_pred: torch.Tensor   # [B, T_text]
    pitch_pred: torch.Tensor     # [B, n_formants, T_text]
    pitch_tgt: torch.Tensor      # [B, n_formants, T_text]
    energy_pred: Optional[torch.Tensor]  # [B, T_text]
    energy_tgt: Optional[torch.Tensor]   # [B, T_text]
    attn_soft: torch.Tensor      # [B, T_mel, T_text]
    attn_hard: torch.Tensor      # [B, T_mel, T_text]
    attn_hard_dur: torch.Tensor  # [B, T_text]
    attn_logprob: torch.Tensor   # [B, T_mel, T_text]


def average_pitch(pitch: torch.Tensor, durs: torch.Tensor) -> torch.Tensor:
    """Mean of the nonzero frame values over each symbol's span (cumsum and
    gather): pitch [B, F, T_frames], durs [B, T_text] -> [B, F, T_text]. A
    span with no nonzero frame averages to 0."""
    durs = durs.long()
    dce = torch.cumsum(durs, dim=1)                        # [B, T_text]
    dcs = F.pad(dce[:, :-1], (1, 0))
    nonzero_cums = F.pad(torch.cumsum((pitch != 0.0).float(), dim=2), (1, 0))
    pitch_cums = F.pad(torch.cumsum(pitch.float(), dim=2), (1, 0))
    shape = (durs.shape[0], pitch.shape[1], durs.shape[1])
    dce_b, dcs_b = dce[:, None, :].expand(shape), dcs[:, None, :].expand(shape)
    sums = torch.gather(pitch_cums, 2, dce_b) - torch.gather(pitch_cums, 2, dcs_b)
    nelems = torch.gather(nonzero_cums, 2, dce_b) - torch.gather(nonzero_cums, 2, dcs_b)
    return torch.where(nelems == 0.0, torch.zeros((), device=pitch.device),
                       sums / torch.clamp_min(nelems, 1.0))


class TemporalPredictor(nn.Module):
    """Duration/pitch/energy predictor head: [B, T, C] -> [B, T, n_predictions]."""

    def __init__(self, in_channels: int, filter_size: int, kernel_size: int,
                 n_layers: int = 2, n_predictions: int = 1, dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList(
            ConvReLUNorm(in_channels if i == 0 else filter_size, filter_size, kernel_size,
                         dropout)
            for i in range(n_layers))
        self.fc = Linear(filter_size, n_predictions)

    def forward(self, enc_out: torch.Tensor, enc_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        m = enc_mask[..., None].to(enc_out.dtype)
        out = enc_out * m
        for layer in self.layers:
            out = layer(out, generator)
        return self.fc(out) * m


class ConvAttention(nn.Module):
    """Mel-query / text-key Gaussian alignment attention (the reference's
    "3xconv" aligner). Returns ``(attn_soft, attn_logprob)``, both
    [B, T_mel, T_text].

    The squared distance is ``|q|² + |k|² − 2·q·kᵀ`` in f32, one batched
    matmul instead of a [B, T_mel, T_text, C] broadcast.
    """

    def __init__(self, n_mel_channels: int = 80, n_text_channels: int = 512,
                 n_attn_channels: int = 80):
        super().__init__()
        self.key_conv1 = ConvNorm(n_text_channels, 2 * n_text_channels, 3)
        self.key_conv2 = ConvNorm(2 * n_text_channels, n_attn_channels, 1)
        self.query_conv1 = ConvNorm(n_mel_channels, 2 * n_mel_channels, 3)
        self.query_conv2 = ConvNorm(2 * n_mel_channels, n_mel_channels, 1)
        self.query_conv3 = ConvNorm(n_mel_channels, n_attn_channels, 1)

    def forward(self, queries: torch.Tensor, keys: torch.Tensor,
                key_mask: Optional[torch.Tensor] = None,
                attn_prior: Optional[torch.Tensor] = None):
        """queries: mel [B, T_mel, n_mel]; keys: text embeddings [B, T_text, C];
        key_mask [B, T_text] bool; attn_prior [B, T_mel, T_text]."""
        k = self.key_conv2(torch.relu(self.key_conv1(keys))).float()
        q = torch.relu(self.query_conv1(queries))
        q = self.query_conv3(torch.relu(self.query_conv2(q))).float()
        dist = ((q * q).sum(-1)[:, :, None] + (k * k).sum(-1)[:, None, :]
                - 2.0 * torch.einsum("bmc,btc->bmt", q, k))
        attn = torch.log_softmax(-0.0005 * dist, dim=-1)
        if attn_prior is not None:
            attn = attn + torch.log(attn_prior + 1e-8)
        attn_logprob = attn
        if key_mask is not None:
            attn = torch.where(key_mask[:, None, :], attn, torch.full((), _NEG, device=attn.device))
        return torch.softmax(attn, dim=-1), attn_logprob


class FastPitch(nn.Module):
    """FastPitch (reference ``FastPitch_TF/model.py:124-410``): the training
    forward (:meth:`forward`) and inference (:meth:`infer`)."""

    def __init__(self, config: FastPitchConfig = FastPitchConfig()):
        super().__init__()
        c = self.config = config
        d = c.symbols_embedding_dim
        self.encoder = FFTransformer(
            n_layer=c.in_fft_n_layers, n_head=c.in_fft_n_heads, d_model=d,
            d_head=c.in_fft_d_head, d_inner=c.in_fft_conv1d_filter_size,
            kernel_size=c.in_fft_conv1d_kernel_size, embed_input=True,
            n_emb=c.n_symbols, padding_idx=c.padding_idx, dropout=c.p_in_fft_dropout,
            dropatt=c.p_in_fft_dropatt, dropemb=c.p_in_fft_dropemb)
        if c.n_speakers > 1:
            self.speaker_emb = nn.Embedding(c.n_speakers, d)  # f32 in bf16 too, as in JAX
        self.duration_predictor = TemporalPredictor(
            d, c.dur_predictor_filter_size, c.dur_predictor_kernel_size,
            n_layers=c.dur_predictor_n_layers, dropout=c.p_dur_predictor_dropout)
        self.decoder = FFTransformer(
            n_layer=c.out_fft_n_layers, n_head=c.out_fft_n_heads, d_model=d,
            d_head=c.out_fft_d_head, d_inner=c.out_fft_conv1d_filter_size,
            kernel_size=c.out_fft_conv1d_kernel_size, embed_input=False,
            dropout=c.p_out_fft_dropout, dropatt=c.p_out_fft_dropatt,
            dropemb=c.p_out_fft_dropemb)
        self.pitch_predictor = TemporalPredictor(
            d, c.pitch_predictor_filter_size, c.pitch_predictor_kernel_size,
            n_layers=c.pitch_predictor_n_layers,
            n_predictions=c.pitch_conditioning_formants,
            dropout=c.p_pitch_predictor_dropout)
        self.pitch_emb = ConvNorm(c.pitch_conditioning_formants, d,
                                  c.pitch_embedding_kernel_size)
        if c.energy_conditioning:
            self.energy_predictor = TemporalPredictor(
                d, c.energy_predictor_filter_size, c.energy_predictor_kernel_size,
                n_layers=c.energy_predictor_n_layers, dropout=c.p_energy_predictor_dropout)
            self.energy_emb = ConvNorm(1, d, c.energy_embedding_kernel_size)
        self.proj = Linear(d, c.n_mel_channels)
        self.attention = ConvAttention(c.n_mel_channels, d, c.n_attn_channels)

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        """As ``nn.Module.load_state_dict``; a state dict without any
        ``attention.*`` key (a serving checkpoint) leaves the aligner as it
        is, and every other key is held to ``strict``."""
        if any(k.startswith("attention.") for k in state_dict):
            return super().load_state_dict(state_dict, strict=strict, assign=assign)
        result = super().load_state_dict(state_dict, strict=False, assign=assign)
        missing = [k for k in result.missing_keys if not k.startswith("attention.")]
        if strict and (missing or result.unexpected_keys):
            raise RuntimeError(f"FastPitch state dict: missing {missing}, "
                               f"unexpected {result.unexpected_keys}")
        return result

    def _speaker_vec(self, speaker):
        c = self.config
        if c.n_speakers <= 1 or speaker is None:
            return None
        return self.speaker_emb(speaker)[:, None, :] * c.speaker_emb_weight

    def forward(self, text: torch.Tensor, input_lens: torch.Tensor, mel_tgt: torch.Tensor,
                mel_lens: torch.Tensor, pitch_dense: torch.Tensor,
                energy_dense: Optional[torch.Tensor] = None, speaker=None,
                attn_prior: Optional[torch.Tensor] = None, *, use_gt_pitch: bool = True,
                pace: float = 1.0, max_duration: float = 75.0,
                generator: Optional[torch.Generator] = None) -> FastPitchOutput:
        """Training forward (JAX ``FastPitch.__call__``).

        text [B, T_text] ids; mel_tgt [B, T_mel, n_mel]; pitch_dense
        [B, n_formants, >= T_mel]; energy_dense [B, >= T_mel]; attn_prior
        [B, T_mel, T_text]. ``generator`` turns dropout on.
        """
        c = self.config
        mel_max_len = mel_tgt.shape[1]
        g = generator
        enc_out, enc_mask = self.encoder(text, conditioning=self._speaker_vec(speaker),
                                         generator=g)
        log_dur_pred = self.duration_predictor(enc_out, enc_mask, g)[..., 0]
        dur_pred = torch.clamp(torch.exp(log_dur_pred) - 1.0, 0.0, max_duration)
        pitch_pred = self.pitch_predictor(enc_out, enc_mask, g).transpose(1, 2)

        # alignment on the raw symbol embeddings, binarized by MAS (a constant)
        text_emb = self.encoder.word_emb(text)
        key_mask = mask_from_lens(input_lens, text.shape[1])
        attn_soft, attn_logprob = self.attention(mel_tgt, text_emb, key_mask, attn_prior)
        attn_hard = maximum_path(torch.log(attn_soft.detach() + 1e-12), input_lens, mel_lens)
        attn_hard_dur = attn_hard.sum(dim=1)  # [B, T_text]
        dur_tgt = attn_hard_dur

        pitch_tgt = average_pitch(pitch_dense[:, :, :mel_max_len], dur_tgt)
        pitch_in = pitch_tgt if use_gt_pitch else pitch_pred
        enc_out = enc_out + self.pitch_emb(pitch_in.transpose(1, 2))

        energy_pred = energy_tgt = None
        if c.energy_conditioning:
            energy_pred = self.energy_predictor(enc_out, enc_mask, g)[..., 0]
            energy_tgt = torch.log(1.0 + average_pitch(energy_dense[:, None, :mel_max_len],
                                                       dur_tgt))
            enc_out = enc_out + self.energy_emb(energy_tgt.transpose(1, 2))
            energy_tgt = energy_tgt[:, 0, :]

        len_regulated, dec_lens = regulate_len(dur_tgt, enc_out, pace, mel_max_len)
        dec_out, dec_mask = self.decoder(len_regulated, seq_lens=dec_lens, generator=g)
        return FastPitchOutput(
            mel_out=self.proj(dec_out), dec_mask=dec_mask, dur_pred=dur_pred,
            log_dur_pred=log_dur_pred, pitch_pred=pitch_pred, pitch_tgt=pitch_tgt,
            energy_pred=energy_pred, energy_tgt=energy_tgt, attn_soft=attn_soft,
            attn_hard=attn_hard, attn_hard_dur=attn_hard_dur, attn_logprob=attn_logprob)

    def infer(self, text: torch.Tensor, input_lens: Optional[torch.Tensor] = None, *,
              pace: float = 1.0, max_mel_len: int = 2048, speaker=None,
              dur_tgt=None, pitch_tgt=None, energy_tgt=None,
              max_duration: float = 75.0, pitch_transform=None):
        """Predicted durations/pitch/energy drive synthesis.

        text: [B, T_text] ids, 0 = padding (the mask comes from the ids, so
        ``input_lens`` is accepted for the JAX signature and not read).
        Returns (mel_out [B, max_mel_len, n_mel], dec_lens [B], dur_pred
        [B, T_text], pitch_pred [B, n_formants, T_text]).

        On a card, in inference mode and eval mode, each shape is captured
        as a CUDA graph on its first call and replayed after that
        (``utils/graphs.py``); the outputs are fresh tensors either way.
        """
        return graphs.run(self, self._infer, text, pace=pace, max_mel_len=max_mel_len,
                          speaker=speaker, dur_tgt=dur_tgt, pitch_tgt=pitch_tgt,
                          energy_tgt=energy_tgt, max_duration=max_duration,
                          pitch_transform=pitch_transform)

    def _infer(self, text, *, pace, max_mel_len, speaker, dur_tgt, pitch_tgt, energy_tgt,
               max_duration, pitch_transform):
        """The eager body of :meth:`infer`."""
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
