"""Feed-forward Transformer (FFT) blocks — the FastPitch backbone.

Counterpart of ``neuraltexttospeech_tpu/nn/transformer.py``: sinusoidal
positional embeddings, ``MultiHeadAttn`` with a fused QKV projection,
``PositionwiseConvFF``, post-LN residual layers and the ``FFTransformer``
wrapper. Inference only: dropout is off.

Masking adds a -1e9 bias on padded keys, as in JAX, so fully padded query
rows stay finite.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..utils.masking import mask_from_lens
from .layers import LN_EPS, ConvNorm

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
    ordered ``[3][n_head][d_head]`` as in JAX."""

    def __init__(self, n_head: int, d_model: int, d_head: int):
        super().__init__()
        self.n_head, self.d_head = n_head, d_head
        self.qkv = nn.Linear(d_model, 3 * n_head * d_head)
        self.o = nn.Linear(n_head * d_head, d_model, bias=False)
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor) -> torch.Tensor:
        """x: [B, T, C]; attn_mask: [B, T] bool, True = valid key."""
        B, T = x.shape[0], x.shape[1]
        qkv = self.qkv(x).view(B, T, 3, self.n_head, self.d_head)
        q, k, v = qkv.unbind(2)  # [B, T, H, D]
        score = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / np.sqrt(self.d_head))
        bias = torch.where(attn_mask[:, None, None, :], 0.0, _NEG)
        prob = torch.softmax(score + bias, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", prob.to(v.dtype), v)
        out = self.o(out.reshape(B, T, self.n_head * self.d_head))
        return self.layer_norm(x + out)


class PositionwiseConvFF(nn.Module):
    """conv(k) -> ReLU -> conv(k), post-LN residual."""

    def __init__(self, d_model: int, d_inner: int, kernel_size: int = 3):
        super().__init__()
        self.conv1 = ConvNorm(d_model, d_inner, kernel_size)
        self.conv2 = ConvNorm(d_inner, d_model, kernel_size)
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer_norm(x + self.conv2(torch.relu(self.conv1(x))))


class FFTransformerLayer(nn.Module):
    """Attention + ConvFF block with the mask re-applied after each."""

    def __init__(self, n_head: int, d_model: int, d_head: int, d_inner: int,
                 kernel_size: int):
        super().__init__()
        self.attn = MultiHeadAttn(n_head, d_model, d_head)
        self.ff = PositionwiseConvFF(d_model, d_inner, kernel_size)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        m = mask[..., None].to(x.dtype)
        x = self.attn(x, mask) * m
        return self.ff(x) * m


class FFTransformer(nn.Module):
    """FFT stack with optional input embedding. Returns ``(out, mask)`` with
    mask [B, T] bool."""

    def __init__(self, n_layer: int, n_head: int, d_model: int, d_head: int,
                 d_inner: int, kernel_size: int, embed_input: bool = True,
                 n_emb: Optional[int] = None, padding_idx: int = 0):
        super().__init__()
        self.d_model = d_model
        self.embed_input = embed_input
        self.padding_idx = padding_idx
        if embed_input:
            self.word_emb = nn.Embedding(n_emb, d_model)
        self.layers = nn.ModuleList(
            FFTransformerLayer(n_head, d_model, d_head, d_inner, kernel_size)
            for _ in range(n_layer))

    def forward(self, x: torch.Tensor, seq_lens: Optional[torch.Tensor] = None,
                conditioning: Optional[torch.Tensor] = None):
        if self.embed_input:
            mask = x != self.padding_idx  # [B, T]
            x = self.word_emb(x)
        else:
            if seq_lens is None:
                raise ValueError("seq_lens is required when embed_input=False")
            mask = mask_from_lens(seq_lens, x.shape[1])

        pos = positional_embedding(x.shape[1], self.d_model, x.device)
        out = x + pos[None] * mask[..., None].to(pos.dtype)
        if conditioning is not None:
            out = out + conditioning
        for layer in self.layers:
            out = layer(out, mask)
        return out, mask
