"""TalkNet 2: the QuartzNet CTC ASR and the grapheme-duration, pitch and
spectrogram heads.

Counterpart of ``neuraltexttospeech_tpu/models/talknet.py`` (:1-294):

- :class:`QuartzNet`: a time-separable conv (depthwise ``groups=C`` with an
  explicit symmetric ``dilation·(k − 1)//2`` pad, which is not SAME at the
  stride-2 initial conv, then a pointwise 1×1, both without bias) → BatchNorm
  → ReLU → Dropout(0.1), the blocks of R separable convs with a pointwise +
  BatchNorm residual (the last repeat's ReLU comes after the residual add),
  the dilation-2 penultimate conv, the final 1×1, and an f32 ``log_softmax``
  (ASR) or f32 regression head. BatchNorm is flax's (``nn/layers.py``):
  momentum 0.5, 0.9 at the last two;
- :func:`ctc_loss` (``optax.ctc_loss``'s mean, by ``F.ctc_loss``),
  :func:`greedy_decode`, :func:`word_error_rate` and :class:`StringMap`
  (copies; the vocabulary is 29 with blank 0);
- :class:`GaussianEmbedding` and the three heads :class:`GraphemeDuration`,
  :class:`PitchPredictor` and :class:`SpectrogramModel`, each with its own
  embedding.

Activations are ``[B, T, C]`` at module boundaries; the backbone runs in
``[B, C, T]`` inside.

Precision follows each module's own config, as flax's ``dtype=`` does, not
the ambient compute dtype of ``nn/precision.py``: a head's embedding and
pitch conv compute in ``TalkNet2Config.dtype``, and the backbone always in
f32, as no CLI of the JAX package sets its ``QuartzNetConfig.dtype``: under
``--amp`` only the embeddings and the pitch conv are bf16, and the Gaussian
expansion's f32 weights lift the embedding back to f32.

Dropout runs only when a call is given a ``torch.Generator``; BatchNorm
takes batch statistics and updates its buffers in train mode
(``module.train()``), and reads its buffers in eval mode.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..nn.layers import BatchNorm, Conv1d, Embedding, dropout
from ..nn.precision import compute_dtype
from ..parallel.mesh import global_mean
from ..utils.masking import mask_from_lens

__all__ = ["QuartzNetConfig", "QuartzNet", "ctc_loss", "greedy_decode", "word_error_rate",
           "StringMap", "GaussianEmbedding", "GraphemeDuration", "PitchPredictor",
           "SpectrogramModel", "TalkNet2Config", "ASR_VOCAB"]

ASR_VOCAB = 29  # len(StringMap()): blank, space, a-z, apostrophe


@dataclasses.dataclass(frozen=True)
class QuartzNetConfig:
    """Model = (5 blocks × block_repeat) × module_repeat (5x5 / 10x5 / 15x5)."""

    block_repeat: int = 1
    module_repeat: int = 5
    block_params: Tuple[Tuple[int, int], ...] = (
        (256, 33), (256, 39), (512, 51), (512, 63), (512, 75))
    initial_filters: int = 256
    initial_kernel: int = 33
    initial_stride: int = 2
    penultimate_filters: int = 512
    penultimate_kernel: int = 87
    final_filters: int = 1024


class SepConv(nn.Module):
    """Depthwise conv (explicit symmetric pad) + pointwise 1×1, no biases,
    over ``[B, C, T]``."""

    def __init__(self, c_in: int, filters: int, kernel: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.depthwise = Conv1d(c_in, c_in, kernel, stride=stride, dilation=dilation,
                                padding=dilation * (kernel - 1) // 2, groups=c_in, bias=False)
        self.pointwise = Conv1d(c_in, filters, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.depthwise(x))


class QuartzNetBlock(nn.Module):
    """R× [sepconv → BN → ReLU] + pointwise/BN residual; the last repeat's
    ReLU follows the residual add."""

    def __init__(self, c_in: int, filters: int, kernel: int, repeat: int):
        super().__init__()
        self.res_conv = Conv1d(c_in, filters, 1, bias=False)
        self.res_bn = BatchNorm(filters, momentum=0.5)
        self.convs = nn.ModuleList(SepConv(c_in if i == 0 else filters, filters, kernel)
                                   for i in range(repeat))
        self.bns = nn.ModuleList(BatchNorm(filters, momentum=0.5) for _ in range(repeat))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = self.res_bn(self.res_conv(x))
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            x = bn(conv(x))
            if i < len(self.convs) - 1:
                x = torch.relu(x)
        return torch.relu(x + res)


class QuartzNet(nn.Module):
    """Backbone + head: ``[B, T, c_input]`` → ``[B, T', c_output]`` f32,
    log-probabilities for the ASR (``T' = ceil(T / 2)`` at the default
    stride 2), raw outputs with ``log_softmax_output=False``. ``stride``
    overrides the initial stride (the TTS heads use 1). ``p_dropout`` is
    the rate after the first conv (JAX's literal 0.1)."""

    def __init__(self, config: QuartzNetConfig = QuartzNetConfig(), c_output: int = ASR_VOCAB,
                 c_input: int = 80, stride: Optional[int] = None,
                 log_softmax_output: bool = True):
        super().__init__()
        c = self.config = config
        self.log_softmax_output = log_softmax_output
        self.p_dropout = 0.1
        self.initial = SepConv(c_input, c.initial_filters, c.initial_kernel,
                               stride=c.initial_stride if stride is None else stride)
        self.initial_bn = BatchNorm(c.initial_filters, momentum=0.5)
        blocks, width = [], c.initial_filters
        for filters, kernel in c.block_params:
            for _ in range(c.block_repeat):
                blocks.append(QuartzNetBlock(width, filters, kernel, c.module_repeat))
                width = filters
        self.blocks = nn.ModuleList(blocks)
        self.penultimate = SepConv(width, c.penultimate_filters, c.penultimate_kernel, dilation=2)
        self.penultimate_bn = BatchNorm(c.penultimate_filters, momentum=0.9)
        self.final_conv = Conv1d(c.penultimate_filters, c.final_filters, 1, bias=False)
        self.final_bn = BatchNorm(c.final_filters, momentum=0.9)
        self.out = Conv1d(c.final_filters, c_output, 1)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        with compute_dtype(torch.float32):
            x = x.transpose(1, 2)
            x = torch.relu(self.initial_bn(self.initial(x)))
            x = dropout(x, self.p_dropout, generator)
            for block in self.blocks:
                x = block(x)
            x = torch.relu(self.penultimate_bn(self.penultimate(x)))
            x = torch.relu(self.final_bn(self.final_conv(x)))
            x = self.out(x)
        x = x.float().transpose(1, 2)
        return torch.log_softmax(x, dim=-1) if self.log_softmax_output else x


def ctc_loss(log_probs: torch.Tensor, logit_lens: torch.Tensor, labels: torch.Tensor,
             label_lens: torch.Tensor, blank_id: int = 0) -> torch.Tensor:
    """Mean over the batch of each utterance's CTC loss (``optax.ctc_loss``,
    unnormalised by length; the global batch's mean under a data-parallel
    mesh). Infinite where a label cannot fit its logits, where optax gives a
    large finite value."""
    per = F.ctc_loss(log_probs.float().transpose(0, 1), labels.long(), logit_lens.long(),
                     label_lens.long(), blank=blank_id, reduction="none")
    return global_mean(per)


def greedy_decode(log_probs: torch.Tensor, logit_lens: torch.Tensor,
                  blank_id: int = 0) -> List[List[int]]:
    """Argmax, collapse repeats, drop blanks (on the host)."""
    ids = log_probs.argmax(dim=-1).cpu().numpy()
    lens = logit_lens.cpu().numpy()
    out = []
    for row, n in zip(ids, lens):
        seq, prev = [], -1
        for s in row[:n]:
            if s != prev and s != blank_id:
                seq.append(int(s))
            prev = s
        out.append(seq)
    return out


def word_error_rate(refs: Sequence[str], hyps: Sequence[str]) -> float:
    """Corpus WER by word-level edit distance."""
    total_err, total_words = word_errors(refs, hyps)
    return total_err / max(total_words, 1)


def word_errors(refs: Sequence[str], hyps: Sequence[str]) -> Tuple[int, int]:
    """The word-level edit distance summed over the pairs, and the number of
    reference words: :func:`word_error_rate`'s two sums."""
    total_err = total_words = 0
    for ref, hyp in zip(refs, hyps):
        r, h = ref.split(), hyp.split()
        d = np.zeros((len(r) + 1, len(h) + 1), np.int32)
        d[:, 0] = np.arange(len(r) + 1)
        d[0, :] = np.arange(len(h) + 1)
        for i in range(1, len(r) + 1):
            for j in range(1, len(h) + 1):
                sub = d[i - 1, j - 1] + (r[i - 1] != h[j - 1])
                d[i, j] = min(sub, d[i - 1, j] + 1, d[i, j - 1] + 1)
        total_err += int(d[len(r), len(h)])
        total_words += len(r)
    return total_err, total_words


class StringMap:
    """char ↔ id lookup; id 0 is the CTC blank."""

    def __init__(self, alphabet: str = " abcdefghijklmnopqrstuvwxyz'"):
        self.id_to_char = ["<blank>"] + list(alphabet)
        self.char_to_id = {c: i for i, c in enumerate(self.id_to_char)}

    def __len__(self):
        return len(self.id_to_char)

    def encode(self, text: str) -> List[int]:
        return [self.char_to_id[c] for c in text.lower() if c in self.char_to_id]

    def decode(self, ids: Sequence[int]) -> str:
        return "".join(self.id_to_char[i] for i in ids if i != 0)


# ----------------------------------------------------------- TalkNet 2 heads

@dataclasses.dataclass(frozen=True)
class TalkNet2Config:
    """The heads' config; ``dtype`` is the embeddings' and the pitch conv's
    compute dtype (None: f32); the backbone computes in f32."""

    n_symbols: int = 148
    emb_dim: int = 256
    n_mel_channels: int = 80
    backbone: QuartzNetConfig = QuartzNetConfig(block_repeat=1, module_repeat=5)
    max_duration: int = 128
    dtype: Optional[torch.dtype] = None


class GaussianEmbedding(nn.Module):
    """Per-token embeddings spread over frames by a softmax over tokens of
    Gaussian log-weights centred on each token's span (sigma ``max(d/2,
    1e-2)``, ``-1e9`` for tokens of zero duration), in f32."""

    def __init__(self, n_symbols: int, emb_dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.embed = Embedding(n_symbols, emb_dim)
        self.dtype = dtype

    def forward(self, text: torch.Tensor, durs: torch.Tensor, mel_max_len: int) -> torch.Tensor:
        """text [B, T_text] ids, durs [B, T_text] frames → [B, T_mel, emb] f32."""
        with compute_dtype(self.dtype):
            emb = self.embed(text)
        durs = durs.float()
        centers = torch.cumsum(durs, dim=1) - durs / 2.0
        sigma = torch.clamp_min(durs / 2.0, 1e-2)
        frames = torch.arange(mel_max_len, dtype=torch.float32, device=durs.device)[None, :, None]
        logit = -0.5 * torch.square((frames - centers[:, None, :]) / sigma[:, None, :])
        logit = torch.where(durs[:, None, :] > 0, logit, torch.full((), -1e9, device=durs.device))
        return torch.bmm(torch.softmax(logit, dim=-1), emb.float())


def _backbone(c: TalkNet2Config, c_input: int, c_output: int) -> QuartzNet:
    return QuartzNet(c.backbone, c_output, c_input, stride=1, log_softmax_output=False)


class GraphemeDuration(nn.Module):
    """Per-token durations: embed → QuartzNet (stride 1) → scalar, zero past
    each text length."""

    def __init__(self, config: TalkNet2Config = TalkNet2Config()):
        super().__init__()
        self.config = config
        self.embed = Embedding(config.n_symbols, config.emb_dim)
        self.backbone = _backbone(config, config.emb_dim, 1)

    def forward(self, text: torch.Tensor, text_lens: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        with compute_dtype(self.config.dtype):
            x = self.embed(text)
        durs = self.backbone(x, generator)[..., 0]
        return durs * mask_from_lens(text_lens, text.shape[1]).to(durs.dtype)


class PitchPredictor(nn.Module):
    """Frame-level (normalised f0, voiced logit) from the duration-expanded
    embeddings."""

    def __init__(self, config: TalkNet2Config = TalkNet2Config()):
        super().__init__()
        self.config = config
        self.embed = GaussianEmbedding(config.n_symbols, config.emb_dim, config.dtype)
        self.backbone = _backbone(config, config.emb_dim, 2)

    def forward(self, text: torch.Tensor, durs: torch.Tensor, mel_max_len: int,
                generator: Optional[torch.Generator] = None):
        x = self.backbone(self.embed(text, durs, mel_max_len), generator)
        return x[..., 0], x[..., 1]


class SpectrogramModel(nn.Module):
    """Mel frames from the expanded embeddings plus a 3-tap SAME conv of the
    frame pitch."""

    def __init__(self, config: TalkNet2Config = TalkNet2Config()):
        super().__init__()
        self.config = config
        self.embed = GaussianEmbedding(config.n_symbols, config.emb_dim, config.dtype)
        self.pitch_conv = Conv1d(1, config.emb_dim, 3, padding=1)
        self.backbone = _backbone(config, config.emb_dim, config.n_mel_channels)

    def forward(self, text: torch.Tensor, durs: torch.Tensor, f0: torch.Tensor,
                mel_max_len: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.embed(text, durs, mel_max_len)
        with compute_dtype(self.config.dtype):
            pitch = self.pitch_conv(f0[:, None, :]).transpose(1, 2)
        return self.backbone(x + pitch, generator)
