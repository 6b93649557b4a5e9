"""flax-exact LSTMs (counterpart of ``flax.linen.LSTMCell``,
``OptimizedLSTMCell`` and ``nn.RNN``, as the JAX package's Tacotron 2 and
Flowtron use them).

- :class:`LSTMCell` has flax's parameters in PyTorch's layout: the input
  kernels ``ii/if/ig/io`` (no bias) stacked as ``weight_ih [4H, in]``, the
  hidden kernels ``hi/hf/hg/ho`` stacked as ``weight_hh [4H, H]`` with their
  biases as ``bias_hh [4H]``, gates in the order i, f, g, o (PyTorch's own).
  Its carry is flax's ``(c, h)``, not PyTorch's ``(h, c)``. Both flax cells
  compute the same function with the same parameters, so one class stands
  for both.
- The cell's ``dtype`` is flax's ``Dense(dtype=)``: the input, the hidden
  state and the kernels are cast to it for the two products, and the gates
  are computed in it; ``None`` promotes (f32 parameters: f32). As in flax,
  ``c' = f·c + i·g`` and ``h' = o·tanh(c')`` then follow type promotion
  against the f32 carry.
- :func:`run_rnn` is ``nn.RNN(cell)(x, seq_lengths=)``: a loop over time
  from zero carries, every step computed, padding included; with
  ``reverse=True`` (flax's ``reverse=True, keep_order=True``) each row is
  flipped within its own length (:func:`flip_sequences`), run forward and
  flipped back, so the backward direction starts at the row's last valid
  token.
- :func:`run_lstm` is ``nn.RNN(cell)(x)`` without lengths, Flowtron's
  density-pass LSTM: on the card one cuDNN call over the whole padded
  buffer (``torch.lstm``, again with a zero input bias), on the CPU the loop.
- :class:`BiLSTM` is the encoder's pair of directions. On the card it runs
  both through cuDNN over a packed sequence (``torch.lstm`` with a zero
  input bias and flax's hidden bias), which gives the loop's values at the
  valid positions and zeros past each length; on the CPU it runs the loop.
"""

from __future__ import annotations

import contextlib
import math
import warnings
from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F
from torch.nn.utils.rnn import PackedSequence, pack_padded_sequence, pad_packed_sequence

__all__ = ["LSTMCell", "run_rnn", "run_lstm", "flip_sequences", "BiLSTM"]

Carry = Tuple[torch.Tensor, torch.Tensor]


class LSTMCell(nn.Module):
    """flax ``LSTMCell``/``OptimizedLSTMCell(features=hidden_size, dtype=)``."""

    def __init__(self, input_size: int, hidden_size: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.input_size, self.hidden_size, self.dtype = input_size, hidden_size, dtype
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden_size, input_size))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden_size, hidden_size))
        self.bias_hh = nn.Parameter(torch.zeros(4 * hidden_size))
        self.reset_parameters()

    def reset_parameters(self):
        """flax's initialisers: lecun-normal input kernels, orthogonal hidden
        kernels (one per gate), zero biases."""
        with torch.no_grad():
            self.weight_ih.normal_(0.0, 1.0 / math.sqrt(self.input_size))
            for w in self.weight_hh.chunk(4, 0):
                nn.init.orthogonal_(w)
            self.bias_hh.zero_()

    def initial_carry(self, batch: int, device) -> Carry:
        """flax's ``initialize_carry``: f32 zeros ``(c, h)``."""
        zeros = torch.zeros(batch, self.hidden_size, device=device)
        return zeros, zeros

    def weights(self, x_dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, ...]:
        """``(weight_ih, weight_hh, bias_hh)`` in the compute dtype: the
        cell's, or without one the promotion of ``x_dtype`` and theirs. A
        loop casts them once and passes them to every step, as XLA hoists
        the casts out of a scan (their gradients then sum in that dtype)."""
        dtype = self.dtype or torch.promote_types(x_dtype, self.weight_ih.dtype)
        return tuple(p.to(dtype) for p in (self.weight_ih, self.weight_hh, self.bias_hh))

    def forward(self, carry: Carry, x: torch.Tensor,
                weights: Optional[Tuple[torch.Tensor, ...]] = None
                ) -> Tuple[Carry, torch.Tensor]:
        """``((c, h), x [..., in]) -> ((c', h'), h')``; ``weights`` are
        :meth:`weights`' (cast here when not given)."""
        c, h = carry
        w_ih, w_hh, b_hh = weights if weights is not None else self.weights(x.dtype)
        gates = F.linear(x.to(w_ih.dtype), w_ih) + F.linear(h.to(w_ih.dtype), w_hh, b_hh)
        i, f, g, o = gates.chunk(4, -1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        new_c = f * c + i * g
        new_h = o * torch.tanh(new_c)
        return (new_c, new_h), new_h


def flip_sequences(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """flax ``flip_sequences`` over ``x [B, T, ...]``: each row's first
    ``lengths[b]`` steps reversed in place, its padding reversed after them
    (position ``t`` takes ``(T - 1 - t + length) mod T``). Its own inverse."""
    T = x.shape[1]
    idx = (T - 1 - torch.arange(T, device=x.device)[None, :]
           + lengths.to(x.device).long()[:, None]) % T
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand_as(x))


def run_rnn(cell: LSTMCell, x: torch.Tensor, lengths: Optional[torch.Tensor] = None,
            reverse: bool = False) -> torch.Tensor:
    """flax ``nn.RNN(cell, reverse=, keep_order=True)(x, seq_lengths=lengths)``
    over ``x [B, T, in]``: the outputs ``[B, T, hidden]`` of every step."""
    if reverse:
        x = flip_sequences(x, lengths) if lengths is not None else x.flip(1)
    carry = cell.initial_carry(x.shape[0], x.device)
    weights = cell.weights(x.dtype)
    outs = []
    for t in range(x.shape[1]):
        carry, y = cell(carry, x[:, t], weights)
        outs.append(y)
    y = torch.stack(outs, 1)
    if reverse:
        y = flip_sequences(y, lengths) if lengths is not None else y.flip(1)
    return y


def _cudnn_weights(cells):
    """``torch.lstm``'s flat weights for ``cells`` (one a direction): flax's
    kernels, a zero input bias and flax's hidden bias."""
    weights = []
    for cell in cells:
        weights += [cell.weight_ih, cell.weight_hh, torch.zeros_like(cell.bias_hh), cell.bias_hh]
    return weights


@contextlib.contextmanager
def _separate_weights():
    """Silence cuDNN's note that the weights are separate tensors, not one
    chunk (it copies them into one for each call)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*contiguous chunk of memory.*")
        yield


def run_lstm(cell: LSTMCell, x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.RNN(cell)(x)`` over ``x [B, T, in]`` from zero carries, every
    step of the padded buffer: ``[B, T, hidden]``. A CUDA input in f32 (the
    cell without a ``dtype``) runs as one cuDNN call; otherwise the loop."""
    dtype = cell.dtype or torch.promote_types(x.dtype, cell.weight_ih.dtype)
    if not x.is_cuda or dtype != torch.float32:
        return run_rnn(cell, x)
    zeros = torch.zeros(1, x.shape[0], cell.hidden_size, device=x.device)
    with _separate_weights():
        return torch.lstm(x.float(), (zeros, zeros), _cudnn_weights([cell]), True, 1, 0.0,
                          torch.is_grad_enabled(), False, True)[0]


class BiLSTM(nn.Module):
    """The two directions of a bidirectional LSTM, concatenated: ``x [B, T,
    in]`` → ``[B, T, 2·hidden]``. Values past each row's length are the
    loop's on the CPU and zero on the card; callers mask them."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.fwd = LSTMCell(input_size, hidden_size)
        self.bwd = LSTMCell(input_size, hidden_size)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        if x.is_cuda:
            return self._cudnn(x, lengths)
        return torch.cat([run_rnn(self.fwd, x, lengths),
                          run_rnn(self.bwd, x, lengths, reverse=True)], -1)

    def _cudnn(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        dtype = torch.promote_types(x.dtype, self.fwd.weight_ih.dtype)
        packed = pack_padded_sequence(x.to(dtype), lengths.cpu().long(), batch_first=True,
                                      enforce_sorted=False)
        zeros = torch.zeros(2, x.shape[0], self.fwd.hidden_size, device=x.device, dtype=dtype)
        with _separate_weights():
            data, _, _ = torch.lstm(packed.data, packed.batch_sizes, (zeros, zeros),
                                    _cudnn_weights((self.fwd, self.bwd)), True, 1, 0.0,
                                    self.training, True)
        out = PackedSequence(data, packed.batch_sizes, packed.sorted_indices,
                             packed.unsorted_indices)
        return pad_packed_sequence(out, batch_first=True, total_length=x.shape[1])[0]
