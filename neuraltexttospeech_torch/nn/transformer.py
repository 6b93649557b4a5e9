"""Feed-forward Transformer (FFT) blocks — the FastPitch backbone.

Counterpart of ``neuraltexttospeech_tpu/nn/transformer.py``: sinusoidal
positional embeddings, ``MultiHeadAttn`` with a fused QKV projection,
``PositionwiseConvFF`` (its second conv's kernel ``kernel_size_2``, 1 in
FastSpeech 2's conv 9 → ReLU → conv 1), post-LN residual layers and the
``FFTransformer`` wrapper. Dropout sits where JAX has it (attention probabilities, the
attention and FFN outputs, the embedding) and runs only when a call is
given a generator (``nn/layers.py``).

Masking adds a -1e9 bias on padded keys, as in JAX, so fully padded query
rows stay finite.

A block that ``parallel/tp.py::shard_params_tp`` sharded holds the mesh in
``tp`` and runs Megatron's layout with its two collectives: the gradient of
the replicated input summed over the model group where it enters a
column-parallel layer (``copy_to_model``), the row-parallel layer's partial
outputs summed after it (``reduce_from_model``).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..parallel.tp import copy_to_model, reduce_from_model
from ..utils.masking import mask_from_lens
from .layers import LN_EPS, ConvNorm, Embedding, LayerNorm, Linear, dropout, promoted_conv

__all__ = [
    "positional_embedding",
    "MultiHeadAttn",
    "PositionwiseConvFF",
    "FFTransformerLayer",
    "FFTransformer",
]

_NEG = -1e9


@functools.lru_cache(maxsize=16)
def positional_embedding(seq_len: int, dim: int,
                         device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """[seq_len, dim] float32 sinusoidal table, computed in float64 numpy.

    inv_freq = 1 / 10000^(2i/dim); emb = concat(sin, cos) along features.
    Cached per (seq_len, dim, device): callers must not write to it.
    """
    inv_freq = 1.0 / (10000.0 ** (np.arange(0.0, dim, 2.0) / dim))
    pos = np.arange(seq_len, dtype=np.float64)
    sinusoid = pos[:, None] * inv_freq[None, :]
    table = np.concatenate([np.sin(sinusoid), np.cos(sinusoid)], axis=-1)
    return torch.as_tensor(table.astype(np.float32), device=device)


class MultiHeadAttn(nn.Module):
    """Post-LN self-attention with fused QKV; output features of ``qkv`` are
    ordered ``[3][n_head][d_head]`` as in JAX. Tensor parallel (``tp`` set),
    ``qkv`` holds whole heads of q, k and v when the model axis divides
    ``n_head`` and is replicated otherwise; ``o`` holds its input features'
    slice."""

    def __init__(self, n_head: int, d_model: int, d_head: int, dropout: float = 0.0,
                 dropatt: float = 0.0):
        super().__init__()
        self.n_head, self.d_head = n_head, d_head
        self.p_dropout, self.p_dropatt = dropout, dropatt
        self.qkv = Linear(d_model, 3 * n_head * d_head)
        self.o = Linear(n_head * d_head, d_model, bias=False)
        self.layer_norm = LayerNorm(d_model, eps=LN_EPS)
        self.tp = None

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: [B, T, C]; attn_mask: [B, T] bool, True = valid key."""
        B, T = x.shape[0], x.shape[1]
        heads = self.qkv.weight.shape[0] // (3 * self.d_head)  # this rank's
        split = heads != self.n_head
        qkv = self.qkv(copy_to_model(x, self.tp) if split else x)
        q, k, v = qkv.view(B, T, 3, heads, self.d_head).unbind(2)  # [B, T, H, D]
        score = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / np.sqrt(self.d_head))
        bias = torch.where(attn_mask[:, None, None, :], 0.0, _NEG).to(score.dtype)
        prob = dropout(torch.softmax(score + bias, dim=-1), self.p_dropatt, generator,
                       model_axis=1 if split else None)
        out = torch.einsum("bhqk,bkhd->bqhd", prob.to(v.dtype), v).reshape(B, T, -1)
        width = self.o.weight.shape[1]
        if self.tp is not None and width != out.shape[-1]:
            # replicated heads, row-parallel o: this rank's slice of the output
            out = copy_to_model(out, self.tp).narrow(-1, self.tp.model_index * width, width)
        out = self.o(out)
        if self.tp is not None:
            out = reduce_from_model(out, self.tp)
        return self.layer_norm(x + dropout(out, self.p_dropout, generator))


class PositionwiseConvFF(nn.Module):
    """conv(k) -> ReLU -> conv(k2) -> dropout, post-LN residual; ``k2``
    (``kernel_size_2``) defaults to ``k``. Tensor parallel (``tp`` set),
    ``conv1`` holds a slice of the inner features' outputs and ``conv2`` of
    its inputs; ``conv2``'s bias is added after the sum."""

    def __init__(self, d_model: int, d_inner: int, kernel_size: int = 3,
                 dropout: float = 0.0, kernel_size_2: Optional[int] = None):
        super().__init__()
        self.conv1 = ConvNorm(d_model, d_inner, kernel_size)
        self.conv2 = ConvNorm(d_inner, d_model, kernel_size_2 or kernel_size)
        self.layer_norm = LayerNorm(d_model, eps=LN_EPS)
        self.p_dropout = dropout
        self.tp = None

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.tp is None:
            y = self.conv2(torch.relu(self.conv1(x)))
        else:
            h = torch.relu(self.conv1(copy_to_model(x, self.tp))).transpose(1, 2)
            y = promoted_conv(self.conv2._conv_forward, h, self.conv2.weight, None)
            y = reduce_from_model(y, self.tp)
            y = (y + self.conv2.bias.to(y.dtype)[:, None]).transpose(1, 2)
        return self.layer_norm(x + dropout(y, self.p_dropout, generator))


class FFTransformerLayer(nn.Module):
    """Attention + ConvFF block with the mask re-applied after each."""

    def __init__(self, n_head: int, d_model: int, d_head: int, d_inner: int,
                 kernel_size: int, dropout: float = 0.0, dropatt: float = 0.0,
                 kernel_size_2: Optional[int] = None):
        super().__init__()
        self.attn = MultiHeadAttn(n_head, d_model, d_head, dropout, dropatt)
        self.ff = PositionwiseConvFF(d_model, d_inner, kernel_size, dropout, kernel_size_2)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        m = mask[..., None].to(x.dtype)
        x = self.attn(x, mask, generator) * m
        return self.ff(x, generator) * m


class FFTransformer(nn.Module):
    """FFT stack with optional input embedding. Returns ``(out, mask)`` with
    mask [B, T] bool."""

    def __init__(self, n_layer: int, n_head: int, d_model: int, d_head: int,
                 d_inner: int, kernel_size: int, embed_input: bool = True,
                 n_emb: Optional[int] = None, padding_idx: int = 0, dropout: float = 0.0,
                 dropatt: float = 0.0, dropemb: float = 0.0,
                 kernel_size_2: Optional[int] = None):
        super().__init__()
        self.d_model = d_model
        self.p_dropemb = dropemb
        self.embed_input = embed_input
        self.padding_idx = padding_idx
        if embed_input:
            self.word_emb = Embedding(n_emb, d_model)
        self.layers = nn.ModuleList(
            FFTransformerLayer(n_head, d_model, d_head, d_inner, kernel_size, dropout, dropatt,
                               kernel_size_2)
            for _ in range(n_layer))

    def forward(self, x: torch.Tensor, seq_lens: Optional[torch.Tensor] = None,
                conditioning: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        if self.embed_input:
            mask = x != self.padding_idx  # [B, T]
            x = self.word_emb(x)
        else:
            if seq_lens is None:
                raise ValueError("seq_lens is required when embed_input=False")
            mask = mask_from_lens(seq_lens, x.shape[1])

        pos = positional_embedding(x.shape[1], self.d_model, x.device).to(x.dtype)
        out = x + pos[None] * mask[..., None].to(x.dtype)
        if conditioning is not None:
            out = out + conditioning
        out = dropout(out, self.p_dropemb, generator)
        for layer in self.layers:
            out = layer(out, mask, generator)
        return out, mask
