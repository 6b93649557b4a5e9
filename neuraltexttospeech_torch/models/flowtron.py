"""Flowtron: an autoregressive normalising flow from text to mel.

Counterpart of ``neuraltexttospeech_tpu/models/flowtron.py`` (:1-491):
``n_flows`` affine AR flow steps that alternate direction in time, each an
attention LSTM over the previous frames, content attention on the text
encoding, a stack of decoder LSTMs and an affine head ``(log_s, b)``, with a
stop gate on the last flow.

- **Density pass** (training): in an affine AR flow frame t is conditioned
  on the *given* frames before it, so each LSTM runs once over the shifted,
  padded buffer from zero carries (``nn/rnn.py::run_lstm``: one cuDNN call
  on the card, the loop on the CPU): the attention LSTM, the attention for
  every frame at once, then each decoder layer, as JAX's one ``nn.RNN`` pass
  per LSTM. ``z = mel·exp(log_s) + b`` over the whole buffer.
- **Generation** (``infer``): a Python loop over frames per flow (JAX's
  ``nn.scan``), ``mel_t = (z_t − b_t)·exp(−log_s_t)``. The Dense layers'
  weights are cast to the compute dtype once a loop, as XLA hoists the casts
  out of a scan; the carry stays f32.
- The odd flows run on each row reversed within its length with the padding
  left in place (:func:`flip_by_lens`, not ``nn/rnn.py::flip_sequences``,
  which reverses the padding too).

Activations are ``[B, T, C]``. Precision is the config's ``dtype``, flax's
``dtype=``: the embedding, convs and Dense layers compute in it; the LSTM
cells have none (f32, bf16 inputs promote), the speaker embedding has none,
and :class:`MaskedInstanceNorm` takes its statistics in its input's type and
returns f32 through its f32 scale and bias. Dropout (0.5 after each encoder
conv) runs when a call is given a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..nn.layers import Conv1d, Embedding, Linear, dropout, same_padding, softmax
from ..nn.precision import compute_dtype, promote
from ..nn.rnn import BiLSTM, LSTMCell, run_lstm
from ..parallel.mesh import global_count, global_mean
from ..utils.masking import mask_from_lens

__all__ = ["FlowtronConfig", "FlowtronOutput", "flip_by_lens", "MaskedInstanceNorm",
           "TextEmbeddingEncoder", "MelEncoder", "GaussianMixture", "FlowtronAttention",
           "ARStep", "Flowtron", "flowtron_loss"]

_NEG = -1e9


@dataclasses.dataclass(frozen=True)
class FlowtronConfig:
    """Defaults = ``Flowtron_TF/config.json`` model_config."""

    n_speakers: int = 1
    n_speaker_dim: int = 128
    n_text: int = 185
    n_text_dim: int = 512
    n_flows: int = 2
    n_mel_channels: int = 80
    n_attn_channels: int = 640
    n_hidden: int = 1024
    n_lstm_layers: int = 2
    mel_encoder_n_hidden: int = 512
    n_components: int = 0
    mean_scale: float = 0.0
    fixed_gaussian: bool = True
    dummy_speaker_embedding: bool = False
    use_gate_layer: bool = True
    sigma: float = 1.0
    dtype: Optional[torch.dtype] = None
    # XLA's unroll of the JAX scans: scheduling only, kept so configs round-trip
    scan_unroll: int = 4


class FlowtronOutput(NamedTuple):
    z: torch.Tensor                 # [B, T_mel, n_mel] latent
    log_s_sum: torch.Tensor         # [B, T_mel, n_mel] the flows' log_s, summed
    gate_out: Optional[torch.Tensor]  # [B, T_mel] logits
    attns: Tuple[torch.Tensor, ...]   # per flow [B, T_mel, T_text]
    mean: Optional[torch.Tensor]
    log_var: Optional[torch.Tensor]
    prob: Optional[torch.Tensor]


def flip_by_lens(x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Each row of ``x [B, T, ...]`` reversed within its first ``lens[b]``
    steps, its padding left in place. Its own inverse."""
    T = x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    n = lens.to(x.device).long()[:, None]
    idx = torch.where(t < n, n - 1 - t, t)
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand_as(x))


def _sum(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sum(x, axis=1, keepdims=True)``: summed in f32, in x's type."""
    return x.sum(1, keepdim=True, dtype=torch.float32).to(x.dtype)


class MaskedInstanceNorm(nn.Module):
    """Affine instance norm over time of ``x [B, T, C]``: per-channel
    statistics over each row's valid steps (``mask [B, T]``; all steps
    without one), computed in x's type, eps 1e-5; the f32 ``weight`` and
    ``bias`` (flax's ``scale``, ``bias``) promote the output."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if mask is None:  # jnp.mean / jnp.var: f32 arithmetic, x's type out
            xf = x.float()
            mean = xf.mean(1, keepdim=True).to(x.dtype)
            var = xf.var(1, unbiased=False, keepdim=True).to(x.dtype)
        else:
            m = mask[..., None].to(x.dtype)
            n = torch.clamp_min(_sum(m), 1.0)
            mean = _sum(x * m) / n
            var = _sum(torch.square(x - mean) * m) / n
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias


def _conv_norm_blocks(x, mask, convs, norms, generator):
    """[conv (SAME) → masked instance norm → ReLU → dropout 0.5] per layer
    over ``x [B, T, C]``."""
    for conv, norm in zip(convs, norms):
        x = conv(x.transpose(1, 2)).transpose(1, 2)
        x = dropout(torch.relu(norm(x, mask)), 0.5, generator)
    return x


class TextEmbeddingEncoder(nn.Module):
    """Embedding → 3 × [conv5 + masked instance norm + ReLU + dropout] →
    BiLSTM (half the width a direction, with lengths) → zero past each
    length."""

    def __init__(self, config: FlowtronConfig):
        super().__init__()
        d = config.n_text_dim
        self.embed = Embedding(config.n_text, d)
        self.convs = nn.ModuleList(Conv1d(d, d, 5, padding=same_padding(5)) for _ in range(3))
        self.norms = nn.ModuleList(MaskedInstanceNorm(d) for _ in range(3))
        self.lstm = BiLSTM(d, d // 2)

    def forward(self, text, text_lens, generator: Optional[torch.Generator] = None):
        mask = mask_from_lens(text_lens, text.shape[1])
        x = _conv_norm_blocks(self.embed(text.long()), mask, self.convs, self.norms, generator)
        out = self.lstm(x, text_lens)
        return out * mask[..., None].to(out.dtype)


class MelEncoder(nn.Module):
    """The utterance's mel embedding: 2 × [conv3 + masked instance norm +
    ReLU + dropout] → BiLSTM → mean over the valid frames → Dense."""

    def __init__(self, config: FlowtronConfig):
        super().__init__()
        h = config.mel_encoder_n_hidden
        self.convs = nn.ModuleList([Conv1d(config.n_mel_channels, h, 3, padding=1),
                                    Conv1d(h, h, 3, padding=1)])
        self.norms = nn.ModuleList(MaskedInstanceNorm(h) for _ in range(2))
        self.lstm = BiLSTM(h, h // 2)
        self.dense = Linear(h, h)

    def forward(self, mel, mel_lens, generator: Optional[torch.Generator] = None):
        mask = mask_from_lens(mel_lens, mel.shape[1])
        x = self.lstm(_conv_norm_blocks(mel, mask, self.convs, self.norms, generator), mel_lens)
        m = mask[..., None].to(x.dtype)
        return self.dense((x * m).sum(1) / torch.clamp_min(m.sum(1), 1.0))


class GaussianMixture(nn.Module):
    """The mixture prior's head: component weights from the mel embedding;
    means and log-variances learned from it, or fixed (unit variance on
    the first ``n_components`` mel axes, scaled by ``mean_scale``)."""

    def __init__(self, config: FlowtronConfig):
        super().__init__()
        self.config = c = config
        h, k = c.mel_encoder_n_hidden, c.n_components
        self.prob = Linear(h, k)
        if not c.fixed_gaussian:
            self.mean = Linear(h, c.n_mel_channels * k)
            self.log_var = Linear(h, c.n_mel_channels * k)

    def forward(self, mel_embedding: torch.Tensor):
        """``[B, h]`` → (mean, log_var ``[B or 1, n_mel, k]``, prob ``[B, k]``)."""
        c = self.config
        prob = softmax(self.prob(mel_embedding))
        if c.fixed_gaussian:
            eye = torch.eye(c.n_mel_channels, device=mel_embedding.device)
            mean = (eye[:, :c.n_components] * c.mean_scale)[None]
            return mean, torch.zeros_like(mean), prob
        shape = (mel_embedding.shape[0], c.n_mel_channels, c.n_components)
        return (self.mean(mel_embedding).reshape(shape),
                self.log_var(mel_embedding).reshape(shape), prob)


def _cast_once(layer: Linear):
    """``layer`` as a function with its weights cast to the compute dtype
    now, for a loop of calls."""
    weight, bias = promote(layer.weight, layer.bias)
    return lambda x: F.linear(promote(x)[0], weight, bias)


class FlowtronAttention(nn.Module):
    """Content attention ``v·tanh(W_q h + W_k text)``, values ``W_v text``."""

    def __init__(self, config: FlowtronConfig):
        super().__init__()
        c = config
        cond, a = c.n_text_dim + c.n_speaker_dim, c.n_attn_channels
        self.query_layer = Linear(c.n_hidden, a, bias=False)
        self.key_layer = Linear(cond, a, bias=False)
        self.value_layer = Linear(cond, a, bias=False)
        self.v = Linear(a, 1, bias=False)

    def project_text(self, text: torch.Tensor):
        return self.key_layer(text), self.value_layer(text)

    def forward(self, queries, keys, values, key_mask, layers=None):
        """queries ``[B, T_mel, H]``; keys/values ``[B, T_text, A]``; key_mask
        ``[B, T_text]`` → (context ``[B, T_mel, A]``, weights ``[B, T_mel,
        T_text]``). ``layers`` replaces ``(query_layer, v)`` (a loop's casts).
        The energies are a ``[B, T_mel, T_text, A]`` tensor, as in JAX."""
        query_layer, v = layers or (self.query_layer, self.v)
        q = query_layer(queries)
        energies = v(torch.tanh(q[:, :, None, :] + keys[:, None, :, :]))[..., 0]
        weights = softmax(torch.where(key_mask[:, None, :], energies, _NEG))
        return torch.bmm(weights, values), weights


class ARStep(nn.Module):
    """One affine AR flow step; the last flow has the stop gate."""

    def __init__(self, config: FlowtronConfig, last_step: bool = False):
        super().__init__()
        self.config = c = config
        a, h = c.n_attn_channels, c.n_hidden
        self.attention_cell = LSTMCell(c.n_mel_channels, h)
        self.attention_layer = FlowtronAttention(c)
        self.decoder_cells = nn.ModuleList(LSTMCell(h + a if i == 0 else h, h)
                                           for i in range(c.n_lstm_layers))
        self.dense1 = Linear(h, h)
        self.dense2 = Linear(h, h)
        # the affine head starts at zero, so that each flow starts as the identity
        self.affine_out = Linear(h, 2 * c.n_mel_channels)
        with torch.no_grad():
            self.affine_out.weight.zero_()
            self.affine_out.bias.zero_()
        self.gate_layer = Linear(h + a, 1) if last_step and c.use_gate_layer else None

    def forward(self, mel, text, text_lens):
        """Density pass: mel ``[B, T, n_mel]`` → (z, log_s, gate logits or
        None, attention weights)."""
        n_mel = self.config.n_mel_channels
        key_mask = mask_from_lens(text_lens, text.shape[1])
        keys, values = self.attention_layer.project_text(text)
        shifted = torch.cat([torch.zeros_like(mel[:, :1]), mel[:, :-1]], 1)
        attn_hidden = run_lstm(self.attention_cell, shifted)
        context, attn_weights = self.attention_layer(attn_hidden, keys, values, key_mask)
        h = torch.cat([attn_hidden, context], -1)
        for cell in self.decoder_cells:
            h = run_lstm(cell, h)
        d = torch.tanh(self.dense2(torch.tanh(self.dense1(h))))
        out = self.affine_out(d)
        log_s, b = out[..., :n_mel], out[..., n_mel:]
        z = mel * torch.exp(log_s) + b
        gate = None
        if self.gate_layer is not None:
            gate = self.gate_layer(torch.cat([d, context], -1))[..., 0]
        return z, log_s, gate, attn_weights

    def infer(self, z, text, text_lens):
        """Generation: ``mel_t = (z_t − b_t)·exp(−log_s_t)`` frame by frame,
        the LSTMs fed the generated frames. Returns (mel ``[B, T, n_mel]``,
        gate logits ``[B, T]`` (zeros without a gate), attention ``[B, T,
        T_text]``)."""
        c = self.config
        B, T = z.shape[:2]
        key_mask = mask_from_lens(text_lens, text.shape[1])
        keys, values = self.attention_layer.project_text(text)
        cells = [self.attention_cell, *self.decoder_cells]
        states = [cell.initial_carry(B, z.device) for cell in cells]
        cell_weights = [cell.weights() for cell in cells]
        dense1, dense2, affine_out = (_cast_once(m) for m in (self.dense1, self.dense2,
                                                               self.affine_out))
        gate_layer = _cast_once(self.gate_layer) if self.gate_layer is not None else None
        attn_layers = (_cast_once(self.attention_layer.query_layer),
                       _cast_once(self.attention_layer.v))
        prev = torch.zeros(B, c.n_mel_channels, device=z.device)
        mels, gates, attns = [], [], []
        for t in range(T):
            states[0], attn_hidden = cells[0](states[0], prev, cell_weights[0])
            context, attn_w = self.attention_layer(attn_hidden[:, None], keys, values, key_mask,
                                                   attn_layers)
            context = context[:, 0]
            h = torch.cat([attn_hidden, context], -1)
            for i in range(1, len(cells)):
                states[i], h = cells[i](states[i], h, cell_weights[i])
            d = torch.tanh(dense2(torch.tanh(dense1(h))))
            out = affine_out(d)
            log_s, b = out[:, :c.n_mel_channels], out[:, c.n_mel_channels:]
            mel_t = (z[:, t] - b) * torch.exp(-log_s)
            gates.append(gate_layer(torch.cat([d, context], -1))[:, 0] if gate_layer is not None
                         else torch.zeros(B, device=z.device))
            mels.append(mel_t)
            attns.append(attn_w[:, 0])
            prev = mel_t.float()
        return torch.stack(mels, 1), torch.stack(gates, 1), torch.stack(attns, 1)


class Flowtron(nn.Module):
    """``n_flows`` alternating-direction AR flows over the text encoding
    and a speaker embedding."""

    def __init__(self, config: FlowtronConfig = FlowtronConfig()):
        super().__init__()
        self.config = c = config
        self.speaker_embedding = nn.Embedding(c.n_speakers, c.n_speaker_dim)  # f32 always
        self.encoder = TextEmbeddingEncoder(c)
        self.flows = nn.ModuleList(ARStep(c, last_step=k == c.n_flows - 1)
                                   for k in range(c.n_flows))
        if c.n_components > 0:
            self.mel_encoder = MelEncoder(c)
            self.gaussian_mixture = GaussianMixture(c)

    def _condition(self, text, text_lens, speaker, generator):
        enc = self.encoder(text, text_lens, generator)
        if self.config.dummy_speaker_embedding:
            speaker = torch.zeros_like(speaker)
        spk = self.speaker_embedding(speaker.long())
        return torch.cat([enc, spk[:, None, :].expand(-1, enc.shape[1], -1)], -1)

    def forward(self, mel, speaker, text, text_lens, mel_lens,
                generator: Optional[torch.Generator] = None) -> FlowtronOutput:
        """Density pass over all flows (training); ``generator`` drops out
        the encoders."""
        c = self.config
        with compute_dtype(c.dtype):
            cond = self._condition(text, text_lens, speaker, generator)
            z, log_s_total, gate_out, attns = mel, torch.zeros_like(mel), None, []
            for k, flow in enumerate(self.flows):
                reverse = k % 2 == 1
                if reverse:
                    z = flip_by_lens(z, mel_lens)
                z, log_s, gate, attn = flow(z, cond, text_lens)
                if reverse:
                    z, log_s, attn = (flip_by_lens(x, mel_lens) for x in (z, log_s, attn))
                    if gate is not None:
                        gate = flip_by_lens(gate[..., None], mel_lens)[..., 0]
                log_s_total = log_s_total + log_s
                if gate is not None:
                    gate_out = gate
                attns.append(attn)
            mean = log_var = prob = None
            if c.n_components > 0:
                mean, log_var, prob = self.gaussian_mixture(
                    self.mel_encoder(mel, mel_lens, generator))
        return FlowtronOutput(z, log_s_total, gate_out, tuple(attns), mean, log_var, prob)

    def infer(self, z, speaker, text, text_lens):
        """Sampling: the flows in reverse order and direction over ``z [B,
        T, n_mel]`` (σ-scaled by the caller). Returns (mel, gate logits in
        forward time, the flows' attentions from the last to the first)."""
        lens = torch.full((z.shape[0],), z.shape[1], dtype=torch.long, device=z.device)
        with compute_dtype(self.config.dtype):
            cond = self._condition(text, text_lens, speaker, None)
            mel, gate, attns = z, None, []
            for k in reversed(range(len(self.flows))):
                reverse = k % 2 == 1
                if reverse:
                    mel = flip_by_lens(mel, lens)
                mel, g, attn = self.flows[k].infer(mel, cond, text_lens)
                if reverse:
                    mel, attn = flip_by_lens(mel, lens), flip_by_lens(attn, lens)
                if k == len(self.flows) - 1:
                    gate = flip_by_lens(g[..., None], lens)[..., 0] if reverse else g
                attns.append(attn)
        return mel, gate, tuple(attns)


def flowtron_loss(output: FlowtronOutput, mel_lens: torch.Tensor,
                  gate_target: Optional[torch.Tensor] = None, sigma: float = 1.0):
    """``(½‖z/σ‖² − Σ log_s) / n`` over the valid frames, ``n = max(frames,
    1)·n_mel``, plus the gate's BCE on the logits, a mean over all ``B·T``
    positions with the mask multiplied in. The mixture head is not in it.
    Under a data-parallel mesh ``n`` and the mean are the global batch's."""
    mask = mask_from_lens(mel_lens, output.z.shape[1])[..., None].float()
    n = torch.clamp_min(global_count(mask.sum()), 1.0) * output.z.shape[-1]
    nll = torch.sum(torch.square(output.z) * mask) / (2 * sigma * sigma)
    logdet = torch.sum(output.log_s_sum * mask)
    loss = (nll - logdet) / n
    meta = {"nll": nll / n, "logdet": logdet / n}
    if output.gate_out is not None and gate_target is not None:
        g = output.gate_out
        gate_loss = global_mean((torch.relu(g) - g * gate_target
                                + torch.log1p(torch.exp(-torch.abs(g)))) * mask[..., 0])
        loss = loss + gate_loss
        meta["gate_loss"] = gate_loss
    meta["loss"] = loss
    return loss, meta
