"""Plain PyTorch references of FastPitch (inference), the HiFi-GAN v1
generator, its two discriminators, the log-mel and the GAN step.

Written from the published layer equations (FastPitch_TF/model.py, jik876
hifi-gan models.py, losses.py) in the port's layouts and parameter names,
so that one set of seeded weights loads into both. Nothing here imports the
port or JAX, and nothing reads a weight, a table or a plan the port made:
the grouped convs are grouped ``F.conv1d``, the log-mel is ``torch.fft.rfft``
and a mel matrix built here, weight norm and spectral norm are written out.

Every matrix product goes through :class:`Arith`: ``f32`` (TF32 off, the
reference), ``tf32`` (both operands of every product rounded to TF32's 10
mantissa bits, the products summed in f32, as the tensor cores' TF32 mode
does: the control of an f32 configuration) or ``fp8`` (both operands
rounded to float8 e4m3 with a scale per tensor, the products summed in f32:
the control of a bf16 configuration). Both controls round in PyTorch, with
TF32 off, so they read the same on the CPU and the card.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F
from torch.nn.utils import parametrize

LN_EPS = 1e-3
LRELU = 0.1
FP8_MAX = 448.0


class Arith:
    """How the reference multiplies: ``f32``, ``tf32`` or ``fp8``."""

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "tf32", "fp8"):
            raise ValueError(f"unknown arithmetic {mode!r}")
        self.mode = mode

    @staticmethod
    @contextlib.contextmanager
    def flags():
        """TF32 off for cuBLAS and cuDNN inside the block."""
        old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """An operand as this arithmetic rounds it (a straight-through copy
        for autograd: the gradient passes unrounded, as the hardware's)."""
        if self.mode == "f32":
            return x
        with torch.no_grad():
            if self.mode == "tf32":
                bits = x.detach().float().contiguous().view(torch.int32)
                r = ((bits + 0x1000) & -0x2000).view(torch.float32)
            else:
                scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
                r = (x.detach().float() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        return x + (r - x).detach()

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)

    def conv1d(self, x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
        return F.conv1d(self.q(x), self.q(w), b, stride, padding, dilation, groups)

    def conv_transpose1d(self, x, w, b, stride, padding):
        return F.conv_transpose1d(self.q(x), self.q(w), b, stride, padding)

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self.q(a), self.q(b))


# ---------------------------------------------------------------- FastPitch

@functools.lru_cache(maxsize=64)
def _positions(length: int, dim: int) -> np.ndarray:
    inv_freq = 1.0 / (10000.0 ** (np.arange(0.0, dim, 2.0) / dim))
    s = np.arange(length, dtype=np.float64)[:, None] * inv_freq[None, :]
    return np.concatenate([np.sin(s), np.cos(s)], axis=-1).astype(np.float32)


class _Lin(nn.Module):
    def __init__(self, cin, cout, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None


class _Conv(nn.Module):
    """A conv's parameters ``weight [cout, cin, k]``, ``bias [cout]``."""

    def __init__(self, cin, cout, k, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None


class _Norm(nn.Module):
    def __init__(self, n):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n))
        self.bias = nn.Parameter(torch.empty(n))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, LN_EPS)


def _same_conv(a: Arith, conv: _Conv, x, dilation=1):
    """SAME conv over [B, T, C] activations (odd kernels)."""
    k = conv.weight.shape[-1]
    y = a.conv1d(x.transpose(1, 2), conv.weight, conv.bias,
                 padding=dilation * (k - 1) // 2, dilation=dilation)
    return y.transpose(1, 2)


class _Attn(nn.Module):
    def __init__(self, d, heads, d_head):
        super().__init__()
        self.heads, self.d_head = heads, d_head
        self.qkv = _Lin(d, 3 * heads * d_head)
        self.o = _Lin(heads * d_head, d, bias=False)
        self.layer_norm = _Norm(d)

    def forward(self, a: Arith, x, mask):
        b, t = x.shape[:2]
        q, k, v = a.linear(x, self.qkv.weight, self.qkv.bias).view(
            b, t, 3, self.heads, self.d_head).unbind(2)
        score = a.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(self.d_head)
        score = score.masked_fill(~mask[:, None, None, :], -1e9)
        out = a.einsum("bhqk,bkhd->bqhd", torch.softmax(score, -1), v).reshape(b, t, -1)
        return self.layer_norm(x + a.linear(out, self.o.weight))


class _FF(nn.Module):
    def __init__(self, d, inner, k):
        super().__init__()
        self.conv1, self.conv2 = _Conv(d, inner, k), _Conv(inner, d, k)
        self.layer_norm = _Norm(d)

    def forward(self, a, x):
        return self.layer_norm(x + _same_conv(a, self.conv2,
                                              torch.relu(_same_conv(a, self.conv1, x))))


class _Layer(nn.Module):
    def __init__(self, d, heads, d_head, inner, k):
        super().__init__()
        self.attn, self.ff = _Attn(d, heads, d_head), _FF(d, inner, k)

    def forward(self, a, x, mask):
        m = mask[..., None].float()
        x = self.attn(a, x, mask) * m
        return self.ff(a, x) * m


class _Stack(nn.Module):
    def __init__(self, n, d, heads, d_head, inner, k, n_emb=None):
        super().__init__()
        if n_emb:
            self.word_emb = nn.Module()
            self.word_emb.weight = nn.Parameter(torch.empty(n_emb, d))
        self.layers = nn.ModuleList(_Layer(d, heads, d_head, inner, k) for _ in range(n))

    def forward(self, a, x, mask):
        pos = torch.as_tensor(_positions(x.shape[1], x.shape[2]), device=x.device)
        x = x + pos[None] * mask[..., None].float()
        for layer in self.layers:
            x = layer(a, x, mask)
        return x


class _ConvReLUNorm(nn.Module):
    def __init__(self, cin, cout, k):
        super().__init__()
        self.conv, self.norm = _Conv(cin, cout, k), _Norm(cout)

    def forward(self, a, x):
        return self.norm(torch.relu(_same_conv(a, self.conv, x)))


class _Predictor(nn.Module):
    def __init__(self, cin, filt, k, n_layers, n_out=1):
        super().__init__()
        self.layers = nn.ModuleList(_ConvReLUNorm(cin if i == 0 else filt, filt, k)
                                    for i in range(n_layers))
        self.fc = _Lin(filt, n_out)

    def forward(self, a, x, mask):
        m = mask[..., None].float()
        x = x * m
        for layer in self.layers:
            x = layer(a, x)
        return a.linear(x, self.fc.weight, self.fc.bias) * m


class _Aligner(nn.Module):
    """The aligner's parameters (the training forward's; inference reads none)."""

    def __init__(self, n_mel, d, n_attn):
        super().__init__()
        self.key_conv1 = _Conv(d, 2 * d, 3)
        self.key_conv2 = _Conv(2 * d, n_attn, 1)
        self.query_conv1 = _Conv(n_mel, 2 * n_mel, 3)
        self.query_conv2 = _Conv(2 * n_mel, n_mel, 1)
        self.query_conv3 = _Conv(n_mel, n_attn, 1)


class FastPitchRef(nn.Module):
    """FastPitch inference, one utterance at a time, at its own length.

    ``cfg`` holds the published widths (the keys of FastPitch_TF's
    arg_parser, as in ``configs/fastpitch-lj.json``)."""

    def __init__(self, cfg: dict):
        super().__init__()
        d = cfg["symbols_embedding_dim"]
        self.cfg = cfg
        self.encoder = _Stack(cfg["in_fft_n_layers"], d, cfg["in_fft_n_heads"],
                              cfg["in_fft_d_head"], cfg["in_fft_conv1d_filter_size"],
                              cfg["in_fft_conv1d_kernel_size"], n_emb=cfg["n_symbols"])
        self.duration_predictor = _Predictor(d, cfg["dur_predictor_filter_size"],
                                             cfg["dur_predictor_kernel_size"],
                                             cfg["dur_predictor_n_layers"])
        self.decoder = _Stack(cfg["out_fft_n_layers"], d, cfg["out_fft_n_heads"],
                              cfg["out_fft_d_head"], cfg["out_fft_conv1d_filter_size"],
                              cfg["out_fft_conv1d_kernel_size"])
        self.pitch_predictor = _Predictor(d, cfg["pitch_predictor_filter_size"],
                                          cfg["pitch_predictor_kernel_size"],
                                          cfg["pitch_predictor_n_layers"])
        self.pitch_emb = _Conv(1, d, cfg["pitch_embedding_kernel_size"])
        self.energy_predictor = _Predictor(d, cfg["energy_predictor_filter_size"],
                                           cfg["energy_predictor_kernel_size"],
                                           cfg["energy_predictor_n_layers"])
        self.energy_emb = _Conv(1, d, cfg["energy_embedding_kernel_size"])
        self.proj = _Lin(d, cfg["n_mel_channels"])
        self.attention = _Aligner(cfg["n_mel_channels"], d, cfg["n_attn_channels"])

    def durations(self, a: Arith, ids: torch.Tensor, width: Optional[int] = None):
        """``(encoder output with pitch and energy added [1, T, d], predicted
        durations [L])`` of one utterance's ids ``[L]``, the text zero-padded
        to ``width`` tokens as the server pads it."""
        n = ids.shape[0]
        text = F.pad(ids, (0, (width or n) - n))[None]
        mask = text != 0
        enc = self.encoder(a, a.q(self.encoder.word_emb.weight[text]), mask)
        log_dur = self.duration_predictor(a, enc, mask)[0, :, 0]
        dur = torch.clamp(torch.exp(log_dur) - 1.0, 0.0, 75.0)
        pitch = self.pitch_predictor(a, enc, mask)
        enc = enc + _same_conv(a, self.pitch_emb, pitch)
        energy = self.energy_predictor(a, enc, mask)
        enc = enc + _same_conv(a, self.energy_emb, energy)
        return enc[:, :n], dur[:n]

    def log_durations(self, a: Arith, ids: torch.Tensor) -> torch.Tensor:
        """The duration head's output (log(1 + frames)) for each token of
        one utterance's ids ``[L]``."""
        text = ids[None]
        mask = text != 0
        enc = self.encoder(a, a.q(self.encoder.word_emb.weight[text]), mask)
        return self.duration_predictor(a, enc, mask)[0, :, 0]

    def decode(self, a: Arith, enc: torch.Tensor, reps: torch.Tensor, max_len: int):
        """Mel ``[n, n_mel]`` of the encoder output ``[1, L, d]`` with each
        token repeated ``reps [L]`` times, cut at ``max_len`` frames. The
        decoder runs over ``max_len`` frames, the ``n`` decoded ones masked
        in, as FastPitch decodes a padded batch: its convs see the frames
        just past the end."""
        x = torch.repeat_interleave(enc[0], reps, dim=0)[:max_len]
        n = x.shape[0]
        x = F.pad(x, (0, 0, 0, max_len - n))[None]
        mask = (torch.arange(max_len, device=x.device) < n)[None]
        y = self.decoder(a, x, mask)
        return a.linear(y, self.proj.weight, self.proj.bias)[0, :n]


def round_durations(dur: torch.Tensor) -> torch.Tensor:
    """Frames a token at pace 1: ``floor(d + 0.5)``."""
    return torch.floor(dur.float() + 0.5).long()


# ------------------------------------------------------ weight and spectral norm

class WeightNorm(nn.Module):
    """``w = v · rsqrt(Σ v² + 1e-12) · scale`` over every dim but 0."""

    def forward(self, v, scale):
        dims = tuple(range(1, v.ndim))
        return v * torch.rsqrt((v * v).sum(dims, keepdim=True) + 1e-12) * scale.reshape(
            (-1,) + (1,) * (v.ndim - 1))

    def right_inverse(self, w):
        return w, torch.sqrt((w * w).sum(tuple(range(1, w.ndim))) + 1e-12)


def _wn(module):
    parametrize.register_parametrization(module, "weight", WeightNorm(), unsafe=True)
    return module


class SpectralNorm(nn.Module):
    """One power step from the stored ``u``; ``w / sigma``."""

    def __init__(self, cout):
        super().__init__()
        self.register_buffer("u", torch.zeros(1, cout))
        self.register_buffer("sigma", torch.ones(()))

    def forward(self, w, update):
        mat = w.reshape(w.shape[0], -1)
        with torch.no_grad():
            v = self.u @ mat
            v = v * torch.rsqrt((v * v).sum(-1, keepdim=True) + 1e-12)
            u = v @ mat.t()
            u = u * torch.rsqrt((u * u).sum(-1, keepdim=True) + 1e-12)
        sigma = (u @ mat @ v.t())[0, 0]
        if update:
            with torch.no_grad():
                self.u.copy_(u)
                self.sigma.copy_(sigma)
        return w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))


# ---------------------------------------------------------------- generator

class _PlainConv(nn.Module):
    def __init__(self, cin, cout, k, transposed=False):
        super().__init__()
        shape = (cin, cout, k) if transposed else (cout, cin, k)
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(cout))


class _ResBlock(nn.Module):
    def __init__(self, ch, k, dilations):
        super().__init__()
        self.dilations = tuple(dilations)
        self.convs1 = nn.ModuleList(_PlainConv(ch, ch, k) for _ in dilations)
        self.convs2 = nn.ModuleList(_PlainConv(ch, ch, k) for _ in dilations)

    def forward(self, a, x):
        k = self.convs1[0].weight.shape[-1]
        for c1, c2, d in zip(self.convs1, self.convs2, self.dilations):
            xt = a.conv1d(F.leaky_relu(x, LRELU), c1.weight, c1.bias,
                          padding=d * (k - 1) // 2, dilation=d)
            x = a.conv1d(F.leaky_relu(xt, LRELU), c2.weight, c2.bias,
                         padding=(k - 1) // 2) + x
        return x


class GeneratorRef(nn.Module):
    """HiFi-GAN generator (``resblock`` "1"): mel [B, T, n_mel] → audio
    [B, T·hop], tanh. ``weight_norm=True`` carries the training
    parametrization (``…parametrizations.weight.original0/1``)."""

    def __init__(self, g: dict, weight_norm: bool = False):
        super().__init__()
        if g["resblock"] != "1":
            raise ValueError("the reference generator has ResBlock1 only")
        ch = g["upsample_initial_channel"]
        self.rates, self.kernels = g["upsample_rates"], g["upsample_kernel_sizes"]
        self.n_res = len(g["resblock_kernel_sizes"])
        self.conv_pre = _PlainConv(g["num_mels"], ch, 7)
        self.ups, self.resblocks = nn.ModuleList(), nn.ModuleList()
        for i, (u, k) in enumerate(zip(self.rates, self.kernels)):
            out = g["upsample_initial_channel"] // 2 ** (i + 1)
            self.ups.append(_PlainConv(ch, out, k, transposed=True))
            ch = out
            for kr, dil in zip(g["resblock_kernel_sizes"], g["resblock_dilation_sizes"]):
                self.resblocks.append(_ResBlock(ch, kr, dil))
        self.conv_post = _PlainConv(ch, 1, 7)
        if weight_norm:
            for m in list(self.modules()):
                if isinstance(m, _PlainConv):
                    _wn(m)

    def forward(self, a: Arith, mel: torch.Tensor) -> torch.Tensor:
        x = a.conv1d(mel.transpose(1, 2), self.conv_pre.weight, self.conv_pre.bias, padding=3)
        for i, (up, u, k) in enumerate(zip(self.ups, self.rates, self.kernels)):
            x = a.conv_transpose1d(F.leaky_relu(x, LRELU), up.weight, up.bias, u, (k - u) // 2)
            blocks = self.resblocks[i * self.n_res:(i + 1) * self.n_res]
            x = sum(block(a, x) for block in blocks) / self.n_res
        x = a.conv1d(F.leaky_relu(x, 0.3), self.conv_post.weight, self.conv_post.bias,
                     padding=3)
        return torch.tanh(x)[:, 0]


# ------------------------------------------------------------ discriminators

def same_pad(x, k, s=1):
    n = x.shape[-1]
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return F.pad(x, (total // 2, total - total // 2))


class _DiscP(nn.Module):
    STRIDES = (3, 3, 3, 3, 1)

    def __init__(self, period):
        super().__init__()
        self.period = period
        ch = (1, 32, 128, 512, 1024, 1024)
        self.convs = nn.ModuleList(_wn(_PlainConv(ci, co, 5)) for ci, co in zip(ch, ch[1:]))
        self.conv_post = _wn(_PlainConv(1024, 1, 3))

    def forward(self, a, x):
        b, t = x.shape
        p = self.period
        if t % p:
            x = F.pad(x[:, None], (0, p - t % p), mode="reflect")[:, 0]
            t = x.shape[1]
        x = x.reshape(b, t // p, p).transpose(1, 2).reshape(b * p, 1, t // p)
        fmap = []
        for conv, s in zip(self.convs, self.STRIDES):
            x = F.leaky_relu(a.conv1d(same_pad(x, 5, s), conv.weight, conv.bias, s), LRELU)
            fmap.append(x)
        x = a.conv1d(same_pad(x, 3), self.conv_post.weight, self.conv_post.bias)
        fmap.append(x)
        return x.reshape(b, p, -1).transpose(1, 2).reshape(b, -1), fmap


class MPDRef(nn.Module):
    PERIODS = (2, 3, 5, 7, 11)

    def __init__(self):
        super().__init__()
        self.discriminators = nn.ModuleList(_DiscP(p) for p in self.PERIODS)

    def scores(self, a, x):
        outs = [d(a, x) for d in self.discriminators]
        return [o[0] for o in outs], [o[1] for o in outs]


class _DiscS(nn.Module):
    SPECS = ((128, 15, 1, 1), (128, 41, 2, 4), (256, 41, 2, 16), (512, 41, 4, 16),
             (1024, 41, 4, 16), (1024, 41, 1, 16), (1024, 5, 1, 1))

    def __init__(self, spectral):
        super().__init__()
        self.spectral = spectral
        ch = (1,) + tuple(s[0] for s in self.SPECS)
        self.convs = nn.ModuleList(_PlainConv(ci // g, co, k)
                                   for ci, (co, k, _, g) in zip(ch, self.SPECS))
        self.conv_post = _PlainConv(1024, 1, 3)
        if spectral:
            self.sn = nn.ModuleList(SpectralNorm(c.weight.shape[0])
                                    for c in list(self.convs) + [self.conv_post])
        else:
            for c in list(self.convs) + [self.conv_post]:
                _wn(c)

    def forward(self, a, x, update):
        fmap = []
        for i, (conv, (_, k, s, g)) in enumerate(zip(self.convs, self.SPECS)):
            w = self.sn[i](conv.weight, update) if self.spectral else conv.weight
            x = F.leaky_relu(a.conv1d(same_pad(x, k, s), w, conv.bias, s, groups=g), LRELU)
            fmap.append(x)
        w = (self.sn[len(self.convs)](self.conv_post.weight, update) if self.spectral
             else self.conv_post.weight)
        x = a.conv1d(same_pad(x, 3), w, self.conv_post.bias)
        fmap.append(x)
        return x.reshape(x.shape[0], -1), fmap


class MSDRef(nn.Module):
    def __init__(self):
        super().__init__()
        self.discriminators = nn.ModuleList(_DiscS(i == 0) for i in range(3))

    def scores(self, a, x, update=False):
        x = x[:, None]
        scores, fmaps = [], []
        for i, d in enumerate(self.discriminators):
            if i:
                x = F.avg_pool1d(same_pad(x, 4, 2), 4, 2)
            s, f = d(a, x, update)
            scores.append(s)
            fmaps.append(f)
        return scores, fmaps


# ------------------------------------------------------------------ log-mel

def hann(n: int) -> np.ndarray:
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


def mel_matrix(n_mels, n_fft, sr, fmin, fmax) -> np.ndarray:
    """``tf.signal.linear_to_mel_weight_matrix`` (HTK scale, DC bin zeroed),
    [n_fft/2 + 1, n_mels], computed in f32 as TensorFlow does."""
    def h2m(f):
        return np.float32(1127.0) * np.log1p(np.asarray(f, np.float32) / np.float32(700.0))

    bins = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1, dtype=np.float32)[1:]
    mel = h2m(bins)[:, None]
    edges = np.linspace(h2m(fmin), h2m(fmax), n_mels + 2, dtype=np.float32)
    lo, c, hi = edges[None, :-2], edges[None, 1:-1], edges[None, 2:]
    w = np.maximum(0.0, np.minimum((mel - lo) / (c - lo), (hi - mel) / (hi - c)))
    return np.pad(w, [[1, 0], [0, 0]]).astype(np.float32)


def log_mel(a: Arith, audio: torch.Tensor, n_fft, hop, win, n_mels, sr, fmin, fmax):
    """HiFi-GAN's log-mel of ``[B, S]`` audio: reflect pad ``(n_fft − hop)/2``
    a side, periodic Hann frames with no end padding, |rFFT|^0.5, the mel
    matrix, log(max(·, 1e-5)) → ``[B, S/hop, n_mels]``."""
    pad = (n_fft - hop) // 2
    x = F.pad(audio.float()[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, win, hop) * torch.as_tensor(hann(win), device=x.device)
    if n_fft > win:
        frames = F.pad(frames, (0, n_fft - win))
    mag = torch.fft.rfft(frames, n=n_fft, dim=-1).abs().pow(0.5)
    basis = torch.as_tensor(mel_matrix(n_mels, n_fft, sr, fmin, fmax), device=x.device)
    return torch.log(torch.clamp(a.einsum("bfk,km->bfm", mag, basis), min=1e-5))


# ----------------------------------------------------------------- GAN step

def gan_losses(a: Arith, gen, mpd, msd, y: torch.Tensor, h: dict):
    """Both lanes of one GAN step on audio ``y [B, S]`` (LSGAN, feature
    matching ×2, 45 · L1 of the log-mels), as ``(g_loss, d_loss)``. The
    generator lane sees the discriminators' pre-step weights and spectral-norm
    state, and no discriminator gradient; the discriminator lane updates the
    spectral-norm state (real pass, then the fake pass from it)."""
    stft = (h["n_fft"], h["hop_size"], h["win_size"], h["num_mels"], h["sampling_rate"])
    fmax_loss = h["fmax_for_loss"] if h.get("fmax_for_loss") is not None else h["sampling_rate"] / 2
    with torch.no_grad():
        mel = log_mel(a, y, *stft, h["fmin"], h["fmax"])
        mel_target = log_mel(a, y, *stft, h["fmin"], fmax_loss)
    y_hat = gen(a, mel)
    loss_mel = torch.mean(torch.abs(log_mel(a, y_hat, *stft, h["fmin"], fmax_loss)
                                    - mel_target)) * 45.0
    disc = list(mpd.parameters()) + list(msd.parameters())
    for p in disc:
        p.requires_grad_(False)
    df_g, ff_g = mpd.scores(a, y_hat)
    ds_g, fs_g = msd.scores(a, y_hat, update=False)
    for p in disc:
        p.requires_grad_(True)
    df_r, ff_r = mpd.scores(a, y)
    ds_r, fs_r = msd.scores(a, y, update=True)
    df_d, _ = mpd.scores(a, y_hat.detach())
    ds_d, _ = msd.scores(a, y_hat.detach(), update=True)

    def d_loss(real, fake):
        return sum(torch.mean((1.0 - r) ** 2) + torch.mean(f ** 2) for r, f in zip(real, fake))

    def fm(real, fake):
        return 2.0 * sum(torch.mean(torch.abs(r.detach() - f))
                         for rs, fs in zip(real, fake) for r, f in zip(rs, fs))

    adv = sum(torch.mean((1.0 - s) ** 2) for s in df_g + ds_g)
    g_loss = adv + fm(ff_r, ff_g) + fm(fs_r, fs_g) + loss_mel
    return g_loss, d_loss(df_r, df_d) + d_loss(ds_r, ds_d)


class Adam:
    """Adam (Kingma & Ba) with bias correction, eps outside the root."""

    def __init__(self, params: Sequence[torch.Tensor], b1: float, b2: float, eps: float = 1e-8):
        self.params, self.b1, self.b2, self.eps, self.t = list(params), b1, b2, eps, 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, lr: float):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad
            if g is None:
                continue
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(lr * (m / c1) / ((v / c2).sqrt() + self.eps))


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each tensor's L2 norm (in float64), by name."""
    names = sorted(tensors)
    vals = torch.stack([torch.linalg.vector_norm(tensors[n].detach().double()) for n in names])
    return dict(zip(names, vals.cpu().tolist()))
