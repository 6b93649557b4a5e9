"""Tacotron 2: embedding → conv + BiLSTM encoder → location-sensitive
attention decoder → postnet, with a gate-stopped autoregressive decode.

Counterpart of ``neuraltexttospeech_tpu/models/tacotron2.py`` (:1-457). JAX's
``nn.scan`` over the decoder cell (teacher-forced forward and ``infer``) and
its ``nn.while_loop`` (``infer(early_stop=True)``) are Python loops over
:class:`DecoderCell` here; each step computes what JAX's does, in the same
types. The teacher-forced loop applies the output projections to all frames
at once after the loop (the same product per frame), and each loop casts
the LSTM weights to the compute dtype once, as XLA hoists those casts out of
JAX's scan.

Activations are ``[B, T, C]`` at module boundaries; the convs run in
``[B, C, T]``, where :class:`~..nn.layers.BatchNorm` normalises axis 1.

Randomness is JAX's ``dropout`` stream: a ``torch.Generator``. The prenet
drops out (p 0.5) whenever a call is given one, in training and in
``infer`` alike (upstream Tacotron 2 keeps it on at inference); the encoder
and postnet (0.5) and the attention and decoder LSTM outputs (0.1) drop out
only in train mode (``module.train()``), which also gives the BatchNorms
batch statistics. Without a generator nothing drops out, which is JAX's
``prenet_deterministic=True`` with dropout off. ``infer`` always runs the
encoder and postnet in eval mode, as JAX's ``train=False``.

Precision is the config's ``dtype``, as flax's ``dtype=``: the convs,
Dense layers, BatchNorm outputs and the decoder's LSTM cells compute in it;
the embedding (flax ``Embed`` has no dtype) and the encoder's BiLSTM (its
``OptimizedLSTMCell``s have none) stay f32, and so do ``memory``, the
attention context (an f32 einsum against it), the softmax's sum and the
decoder's carry, cast back to f32 after every step as JAX's is.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..nn.layers import BatchNorm, Conv1d, Linear, dropout, same_padding, softmax
from ..nn.precision import compute_dtype
from ..nn.rnn import BiLSTM, LSTMCell
from ..parallel.mesh import global_mean
from ..utils.masking import mask_from_lens

__all__ = ["Tacotron2Config", "Tacotron2Output", "Tacotron2", "tacotron2_loss"]

_NEG = -1e9


@dataclasses.dataclass(frozen=True)
class Tacotron2Config:
    n_mel_channels: int = 80
    n_symbols: int = 148
    symbols_embedding_dim: int = 512
    # encoder
    encoder_kernel_size: int = 5
    encoder_n_convolutions: int = 3
    encoder_embedding_dim: int = 512
    # decoder
    n_frames_per_step: int = 1
    decoder_rnn_dim: int = 1024
    prenet_dim: int = 256
    max_decoder_steps: int = 1000
    gate_threshold: float = 0.5
    p_attention_dropout: float = 0.1
    p_decoder_dropout: float = 0.1
    # attention
    attention_rnn_dim: int = 1024
    attention_dim: int = 128
    attention_location_n_filters: int = 32
    attention_location_kernel_size: int = 31
    # postnet
    postnet_embedding_dim: int = 512
    postnet_kernel_size: int = 5
    postnet_n_convolutions: int = 5
    mask_padding: bool = True
    dtype: Optional[torch.dtype] = None
    # XLA's unroll of the JAX decoder scan: scheduling only, ignored here
    scan_unroll: int = 4


class Tacotron2Output(NamedTuple):
    mel_out: torch.Tensor           # [B, T_mel, n_mel] decoder output
    mel_out_postnet: torch.Tensor   # [B, T_mel, n_mel] + postnet residual
    gate_out: torch.Tensor          # [B, T_mel] logits
    alignments: torch.Tensor        # [B, T_mel, T_text]
    mel_lengths: Optional[torch.Tensor] = None  # inference only


class Prenet(nn.Module):
    """2 × (Dense without bias → ReLU → dropout 0.5)."""

    def __init__(self, in_dim: int, dim: int = 256):
        super().__init__()
        self.layers = nn.ModuleList([Linear(in_dim, dim, bias=False),
                                     Linear(dim, dim, bias=False)])

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for layer in self.layers:
            x = dropout(torch.relu(layer(x)), 0.5, generator)
        return x


class LocationLayer(nn.Module):
    """SAME conv (no bias) over the stacked (weights, cumulative weights)
    ``[B, T_text, 2]``, then a Dense without bias → ``[B, T_text, attention_dim]``."""

    def __init__(self, n_filters: int = 32, kernel_size: int = 31, attention_dim: int = 128):
        super().__init__()
        self.conv = Conv1d(2, n_filters, kernel_size, padding=same_padding(kernel_size),
                           bias=False)
        self.dense = Linear(n_filters, attention_dim, bias=False)

    def forward(self, weights_cat: torch.Tensor) -> torch.Tensor:
        return self.dense(self.conv(weights_cat.transpose(1, 2)).transpose(1, 2))


class Attention(nn.Module):
    """Location-sensitive attention."""

    def __init__(self, query_dim: int, memory_dim: int, attention_dim: int = 128,
                 location_n_filters: int = 32, location_kernel_size: int = 31):
        super().__init__()
        self.query_layer = Linear(query_dim, attention_dim, bias=False)
        self.memory_layer = Linear(memory_dim, attention_dim, bias=False)
        self.v = Linear(attention_dim, 1, bias=False)
        self.location_layer = LocationLayer(location_n_filters, location_kernel_size,
                                            attention_dim)

    def forward(self, query, memory, processed_memory, weights_cat, mask):
        """query [B, rnn_dim]; memory [B, T, C]; mask [B, T] bool valid →
        (context [B, C], weights [B, T])."""
        energies = self.v(torch.tanh(self.query_layer(query)[:, None, :]
                                     + self.location_layer(weights_cat)
                                     + processed_memory))[..., 0]
        weights = softmax(torch.where(mask, energies, _NEG))
        dtype = torch.promote_types(weights.dtype, memory.dtype)
        context = torch.bmm(weights[:, None, :].to(dtype), memory.to(dtype))[:, 0]
        return context, weights


# (attention c, attention h, decoder c, decoder h, weights, cumulative
# weights, context), each [B, *] f32
Carry = Tuple[torch.Tensor, ...]


class DecoderCell(nn.Module):
    """One decoder step: attention LSTM → attention → decoder LSTM; the
    frame and gate projections are :meth:`project`."""

    def __init__(self, config: "Tacotron2Config"):
        super().__init__()
        c = self.config = config
        enc = c.encoder_embedding_dim
        self.prenet = Prenet(c.n_mel_channels, c.prenet_dim)
        self.attention_rnn = LSTMCell(c.prenet_dim + enc, c.attention_rnn_dim, dtype=c.dtype)
        self.attention_layer = Attention(c.attention_rnn_dim, enc, c.attention_dim,
                                         c.attention_location_n_filters,
                                         c.attention_location_kernel_size)
        self.decoder_rnn = LSTMCell(c.attention_rnn_dim + enc, c.decoder_rnn_dim, dtype=c.dtype)
        self.linear_projection = Linear(c.decoder_rnn_dim + enc,
                                        c.n_mel_channels * c.n_frames_per_step)
        self.gate_layer = Linear(c.decoder_rnn_dim + enc, 1)

    def init_carry(self, batch: int, t_text: int, device) -> Carry:
        c = self.config

        def zeros(*shape):
            return torch.zeros(batch, *shape, device=device)

        return (zeros(c.attention_rnn_dim), zeros(c.attention_rnn_dim),
                zeros(c.decoder_rnn_dim), zeros(c.decoder_rnn_dim), zeros(t_text),
                zeros(t_text), zeros(c.encoder_embedding_dim))

    def lstm_weights(self):
        """The two LSTM cells' weights in their compute dtype, cast once for
        a whole loop (:meth:`~..nn.rnn.LSTMCell.weights`)."""
        return self.attention_rnn.weights(), self.decoder_rnn.weights()

    def forward(self, carry: Carry, prenet_out: torch.Tensor, memory, processed_memory, mask,
                generator: Optional[torch.Generator] = None, lstm_weights=None):
        """``prenet_out`` [B, prenet_dim] is the prenet's output for this
        step; ``generator`` drops out the two LSTM outputs; ``lstm_weights``
        are :meth:`lstm_weights`' (cast here when not given). Returns (the
        new carry, the projections' input [B, dec + enc], the attention
        weights)."""
        c = self.config
        attn_w, dec_w = lstm_weights if lstm_weights is not None else self.lstm_weights()
        attn_c, attn_h, dec_c, dec_h, weights, weights_cum, context = carry
        (attn_c, attn_h), _ = self.attention_rnn((attn_c, attn_h),
                                                 torch.cat([prenet_out, context], -1), attn_w)
        attn_hidden = dropout(attn_h, c.p_attention_dropout, generator)
        context, weights = self.attention_layer(
            attn_hidden, memory, processed_memory, torch.stack([weights, weights_cum], -1),
            mask)
        weights_cum = weights_cum + weights
        (dec_c, dec_h), _ = self.decoder_rnn((dec_c, dec_h),
                                             torch.cat([attn_hidden, context], -1), dec_w)
        dec_hidden = dropout(dec_h, c.p_decoder_dropout, generator)
        proj_input = torch.cat([dec_hidden, context], -1)
        new = (attn_c, attn_h, dec_c, dec_h, weights, weights_cum, context)
        return tuple(x.to(old.dtype) for x, old in zip(new, carry)), proj_input, weights

    def project(self, proj_input: torch.Tensor):
        """(frame [..., n_mel], gate logit [...])."""
        return self.linear_projection(proj_input), self.gate_layer(proj_input)[..., 0]


class Postnet(nn.Module):
    """5 × [SAME conv → BatchNorm (momentum 0.9) → tanh (not the last) →
    dropout 0.5] over ``[B, C, T]``."""

    def __init__(self, config: "Tacotron2Config"):
        super().__init__()
        c = config
        dims = ([c.n_mel_channels] + [c.postnet_embedding_dim] * (c.postnet_n_convolutions - 1)
                + [c.n_mel_channels])
        pad = same_padding(c.postnet_kernel_size)
        self.convs = nn.ModuleList(Conv1d(a, b, c.postnet_kernel_size, padding=pad)
                                   for a, b in zip(dims[:-1], dims[1:]))
        self.norms = nn.ModuleList(BatchNorm(b, momentum=0.9) for b in dims[1:])

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """``[B, T, n_mel]`` → the residual ``[B, T, n_mel]``."""
        x = x.transpose(1, 2)
        for i, (conv, norm) in enumerate(zip(self.convs, self.norms)):
            x = norm(conv(x))
            if i < len(self.convs) - 1:
                x = torch.tanh(x)
            x = dropout(x, 0.5, generator)
        return x.transpose(1, 2)


class Encoder(nn.Module):
    """3 × [conv5 → BatchNorm (momentum 0.9) → ReLU → dropout 0.5] → the f32
    BiLSTM (half the width a direction) → zero past each length."""

    def __init__(self, config: "Tacotron2Config"):
        super().__init__()
        c = config
        dims = [c.symbols_embedding_dim] + [c.encoder_embedding_dim] * c.encoder_n_convolutions
        pad = same_padding(c.encoder_kernel_size)
        self.convs = nn.ModuleList(Conv1d(a, b, c.encoder_kernel_size, padding=pad)
                                   for a, b in zip(dims[:-1], dims[1:]))
        self.norms = nn.ModuleList(BatchNorm(b, momentum=0.9) for b in dims[1:])
        self.lstm = BiLSTM(c.encoder_embedding_dim, c.encoder_embedding_dim // 2)

    def forward(self, x: torch.Tensor, input_lens: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.transpose(1, 2)
        for conv, norm in zip(self.convs, self.norms):
            x = dropout(torch.relu(norm(conv(x))), 0.5, generator)
        out = self.lstm(x.transpose(1, 2), input_lens)
        return out * mask_from_lens(input_lens, x.shape[2])[..., None].to(out.dtype)


@contextlib.contextmanager
def _eval_mode(module: nn.Module):
    was = module.training
    module.eval()
    try:
        yield
    finally:
        module.train(was)


class Tacotron2(nn.Module):
    def __init__(self, config: Tacotron2Config = Tacotron2Config()):
        super().__init__()
        c = self.config = config
        self.embedding = nn.Embedding(c.n_symbols, c.symbols_embedding_dim)
        val = (6.0 / (c.n_symbols + c.symbols_embedding_dim)) ** 0.5
        with torch.no_grad():
            self.embedding.weight.uniform_(-val, val)
        self.encoder = Encoder(c)
        self.cell = DecoderCell(c)
        self.postnet = Postnet(c)

    def _encode(self, text, input_lens, generator):
        memory = self.encoder(self.embedding(text.long()), input_lens, generator)
        processed_memory = self.cell.attention_layer.memory_layer(memory)
        return memory, processed_memory, mask_from_lens(input_lens, text.shape[1])

    def _mask_outputs(self, mel, mel_postnet, gate, output_lens):
        if output_lens is None or not self.config.mask_padding:
            return mel, mel_postnet, gate
        mask = mask_from_lens(output_lens, mel.shape[1])
        melm = mask[..., None].to(mel.dtype)
        gate = torch.where(mask, gate, 1e3)  # padded gates: "stopped"
        return mel * melm, mel_postnet * melm, gate

    def forward(self, text, input_lens, mel_tgt, output_lens=None,
                generator: Optional[torch.Generator] = None) -> Tacotron2Output:
        """Teacher-forced forward; ``mel_tgt`` [B, T_mel, n_mel]."""
        train_gen = generator if self.training else None
        with compute_dtype(self.config.dtype):
            memory, processed_memory, mask = self._encode(text, input_lens, train_gen)
            # teacher forcing: the prenet over [go frame; mel_tgt[:-1]] at once
            dec_in = torch.cat([torch.zeros_like(mel_tgt[:, :1]), mel_tgt[:, :-1]], 1)
            prenet_out = self.cell.prenet(dec_in, generator)
            carry = self.cell.init_carry(text.shape[0], text.shape[1], text.device)
            lstm_weights = self.cell.lstm_weights()
            projs, aligns = [], []
            for t in range(mel_tgt.shape[1]):
                carry, proj, weights = self.cell(carry, prenet_out[:, t], memory,
                                                 processed_memory, mask, train_gen, lstm_weights)
                projs.append(proj)
                aligns.append(weights)
            mel_out, gate_out = self.cell.project(torch.stack(projs, 1))
            mel_post = mel_out + self.postnet(mel_out, train_gen)
            mel_out, mel_post, gate_out = self._mask_outputs(mel_out, mel_post, gate_out,
                                                             output_lens)
        return Tacotron2Output(mel_out, mel_post, gate_out, torch.stack(aligns, 1))

    def infer(self, text, input_lens, *, max_decoder_steps: Optional[int] = None,
              early_stop: bool = False,
              generator: Optional[torch.Generator] = None) -> Tacotron2Output:
        """Free-running decode with the gate-threshold stop, eval mode;
        ``generator`` drives the prenet's dropout (None: off).

        The scan form runs ``max_decoder_steps``: a row whose gate has fired
        keeps feeding its new frames back (its attention and gates go on),
        but emits zeros; ``mel_lengths`` counts the steps up to and with the
        one where its gate fired, and past it the mels are zeroed and the
        gates set to 1e3 (the alignments are not masked). ``early_stop``
        is JAX's ``_infer_while``: it stops after the first step where every
        row has fired, into f32 buffers of ``max_decoder_steps`` frames (gates
        1e3 beyond), and counts a row's frames with any nonzero value."""
        c = self.config
        T = max_decoder_steps or c.max_decoder_steps
        B = text.shape[0]
        with _eval_mode(self), compute_dtype(c.dtype):
            memory, processed_memory, mask = self._encode(text, input_lens, None)
            carry = self.cell.init_carry(B, text.shape[1], text.device)
            frame = torch.zeros(B, c.n_mel_channels, device=text.device)
            finished = torch.zeros(B, dtype=torch.bool, device=text.device)
            lstm_weights = self.cell.lstm_weights()
            outs: List[tuple] = []
            for _ in range(T):
                carry, proj, weights = self.cell(carry, self.cell.prenet(frame, generator),
                                                 memory, processed_memory, mask, None,
                                                 lstm_weights)
                new_frame, gate = self.cell.project(proj)
                emit = torch.where(finished[:, None], 0.0, new_frame)
                outs.append((emit, gate, weights, ~finished))
                finished = finished | (torch.sigmoid(gate) > c.gate_threshold)
                frame = new_frame.to(frame.dtype)
                if early_stop and bool(finished.all()):
                    break
            mel_out, gate_out, alignments, running = (torch.stack(x, 1) for x in zip(*outs))
            if early_stop:
                mel_out, gate_out, alignments = self._while_buffers(
                    mel_out, gate_out, alignments, T)
                mel_lengths = torch.sum(torch.any(mel_out != 0.0, -1), 1)
            else:
                mel_lengths = torch.sum(running, 1)
            mel_post = mel_out + self.postnet(mel_out)
            mel_out, mel_post, gate_out = self._mask_outputs(mel_out, mel_post, gate_out,
                                                             mel_lengths)
        return Tacotron2Output(mel_out, mel_post, gate_out, alignments, mel_lengths)

    @staticmethod
    def _while_buffers(mel, gate, alignments, T):
        """The steps run, written into ``_infer_while``'s f32 buffers of T
        frames: mels and alignments zero beyond, gates 1e3."""
        B, n = gate.shape

        def buf(x, fill):
            out = torch.full((B, T) + x.shape[2:], fill, device=x.device)
            out[:, :n] = x
            return out

        return buf(mel, 0.0), buf(gate, 1e3), buf(alignments, 0.0)


def tacotron2_loss(output: Tacotron2Output, mel_tgt: torch.Tensor, gate_tgt: torch.Tensor):
    """Mel MSE (decoder + postnet) + gate BCE on the logits: means over
    the global batch under a data-parallel mesh."""
    mel_loss = (global_mean(torch.square(output.mel_out - mel_tgt))
                + global_mean(torch.square(output.mel_out_postnet - mel_tgt)))
    g = output.gate_out
    gate_loss = global_mean(torch.relu(g) - g * gate_tgt + torch.log1p(torch.exp(-torch.abs(g))))
    return mel_loss + gate_loss, {"mel_loss": mel_loss, "gate_loss": gate_loss}
