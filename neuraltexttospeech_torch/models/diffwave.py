"""DiffWave — the diffusion waveform vocoder.

Counterpart of ``neuraltexttospeech_tpu/models/diffwave.py``: the config
(same defaults), the step embedding with its fractional lerp, the mel
upsampler, the gated dilated residual stack, the L1 noise-prediction loss,
the host-side sampling schedule and the reverse sampler.

Activations are ``[batch, channels, time]`` inside the network (PyTorch's
conv layout); the module's inputs and output are JAX's: audio ``[B, T]``,
mel ``[B, F, n_mels]``, noise estimate ``[B, T]``.

- The step table is built in numpy float32 exactly as the JAX module builds
  it: its arguments reach ~5e5 rad, where a device ``sin`` would differ.
- The upsampler's flax layer is ``ConvTranspose((32, 3), (16, 1), "SAME",
  transpose_kernel=True)``, which pads the dilated input by 23 = 32 - 1 - 8
  on each side of time and by 1 on each side of mel: here
  ``conv_transpose2d`` with padding (8, 1) (the JAX package computes it as
  a 9-tap stencil, ``_StencilConvTranspose16``; both are the same function).
- ``folded_convs`` is a TPU lane-filling rewrite of the residual stack; the
  port runs the stack unfolded and refuses the flag.
- Randomness (the loss's steps and noise, the sampler's start and per-step
  noise) comes in as arguments or from a ``torch.Generator``.

Under a bf16 compute dtype (``nn/precision.py``) the layers compute in bf16
as flax's ``dtype=`` does, and the residual stream and the skip sum are
f32 after their scaling: JAX divides them by ``np.sqrt(...)``, a numpy f64
scalar, which promotes bf16 to f32.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..nn.layers import Conv1d, ConvTranspose2d, Linear
from ..parallel.mesh import global_draw, global_mean

__all__ = ["DiffWaveConfig", "DiffWave", "DiffusionEmbedding", "SpectrogramUpsampler",
           "ResidualBlock", "diffwave_loss", "sampling_schedule", "reverse_sample"]


@dataclasses.dataclass(frozen=True)
class DiffWaveConfig:
    """Defaults = reference ``DiffWave_TF/params.py:24-51``."""

    sample_rate: int = 22050
    n_mels: int = 80
    hop_length: int = 256
    crop_mel_frames: int = 62
    residual_layers: int = 30
    residual_channels: int = 64
    dilation_cycle_length: int = 10
    unconditional: bool = False
    noise_schedule: Tuple[float, ...] = tuple(np.linspace(1e-4, 0.05, 50).tolist())
    inference_noise_schedule: Tuple[float, ...] = (0.0001, 0.001, 0.01, 0.05, 0.2, 0.5)
    audio_len: int = 22050 * 5          # unconditional synthesis length
    learning_rate: float = 2e-4
    batch_size: int = 16
    max_grad_norm: Optional[float] = None
    folded_convs: bool = False

    def __post_init__(self):
        if self.folded_convs:
            raise ValueError("folded_convs=True is a TPU lowering of the residual stack; "
                             "the port runs it unfolded (folded_convs=False)")

    @property
    def num_steps(self) -> int:
        return len(self.noise_schedule)


def step_table(max_steps: int) -> np.ndarray:
    """The sin/cos step table [max_steps, 128], float32 throughout as the
    JAX module builds it (``diffwave.py:77-86``)."""
    steps = np.arange(max_steps, dtype=np.float32)[:, None]
    dims = np.arange(64, dtype=np.float32)[None, :]
    table = steps * np.float32(10.0) ** (dims * np.float32(4.0 / 63.0))
    return np.concatenate([np.sin(table), np.cos(table)], axis=1).astype(np.float32)


class DiffusionEmbedding(nn.Module):
    """Step embedding: an integer step gathers its table row, a fractional
    one lerps between the rows of its floor and ceil; then two SiLU MLPs."""

    def __init__(self, max_steps: int):
        super().__init__()
        self.register_buffer("table", torch.from_numpy(step_table(max_steps)),
                             persistent=False)
        self.projection1 = Linear(128, 512)
        self.projection2 = Linear(512, 512)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        if t.is_floating_point():
            low, high = torch.floor(t).long(), torch.ceil(t).long()
            frac = (t - low.to(t.dtype))[:, None]
            x = self.table[low] * (1 - frac) + self.table[high] * frac
        else:
            x = self.table[t.long()]
        x = F.silu(self.projection1(x))
        return F.silu(self.projection2(x))


class SpectrogramUpsampler(nn.Module):
    """mel [B, F, n_mels] → [B, 256·F, n_mels]: two ×16 transposed convs
    over (time, mel), each followed by LeakyReLU 0.4."""

    def __init__(self):
        super().__init__()
        self.conv1 = ConvTranspose2d(1, 1, (32, 3), stride=(16, 1), padding=(8, 1))
        self.conv2 = ConvTranspose2d(1, 1, (32, 3), stride=(16, 1), padding=(8, 1))

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.conv1(mel[:, None]), 0.4)
        return F.leaky_relu(self.conv2(x), 0.4)[:, 0]


class ResidualBlock(nn.Module):
    """Gated dilated residual block: the step's projection added, a dilated
    conv3 ("same" padding), the conditioner's 1×1 added, the gate (first
    half) times the filter (second half), a 1×1 split into the residual and
    the skip; returns ``((x + residual) / √2, skip)``."""

    def __init__(self, n_mels: int, channels: int, dilation: int, unconditional: bool = False):
        super().__init__()
        self.diffusion_projection = Linear(512, channels)
        self.dilated_conv = Conv1d(channels, 2 * channels, 3, padding=dilation,
                                   dilation=dilation)
        self.conditioner_projection = (None if unconditional
                                       else Conv1d(n_mels, 2 * channels, 1))
        self.output_projection = Conv1d(channels, 2 * channels, 1)

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                conditioner: Optional[torch.Tensor] = None):
        """x [B, C, T]; emb [B, 512]; conditioner [B, n_mels, T] or None."""
        y = self.dilated_conv(x + self.diffusion_projection(emb)[:, :, None])
        if self.conditioner_projection is not None:
            y = y + self.conditioner_projection(conditioner)
        gate, filt = y.chunk(2, dim=1)
        residual, skip = self.output_projection(torch.sigmoid(gate) * torch.tanh(filt)).chunk(
            2, dim=1)
        return (x + residual).float() / math.sqrt(2.0), skip


class DiffWave(nn.Module):
    """The noise estimator: audio [B, T], step [B] (integer, or fractional in
    fast sampling), mel [B, T // hop, n_mels] (None when unconditional) →
    [B, T]."""

    def __init__(self, config: DiffWaveConfig = DiffWaveConfig()):
        super().__init__()
        self.config = c = config
        C = c.residual_channels
        self.input_projection = Conv1d(1, C, 1)
        self.diffusion_embedding = DiffusionEmbedding(c.num_steps)
        self.spectrogram_upsampler = None if c.unconditional else SpectrogramUpsampler()
        self.residual_layers = nn.ModuleList(
            ResidualBlock(c.n_mels, C, 2 ** (i % c.dilation_cycle_length), c.unconditional)
            for i in range(c.residual_layers))
        self.skip_projection = Conv1d(C, C, 1)
        self.output_projection = Conv1d(C, 1, 1)
        nn.init.zeros_(self.output_projection.weight)
        nn.init.zeros_(self.output_projection.bias)

    def forward(self, audio: torch.Tensor, diffusion_step: torch.Tensor,
                spectrogram: Optional[torch.Tensor] = None) -> torch.Tensor:
        T = audio.shape[-1]
        x = F.relu(self.input_projection(audio[:, None]))
        emb = self.diffusion_embedding(diffusion_step)
        cond = None
        if self.spectrogram_upsampler is not None:
            if spectrogram is None:
                raise ValueError("a conditional DiffWave needs a spectrogram")
            cond = self.spectrogram_upsampler(spectrogram)[:, :T].transpose(1, 2)
        skip_sum = None
        for layer in self.residual_layers:
            x, skip = layer(x, emb, cond)
            skip_sum = skip if skip_sum is None else skip_sum + skip
        x = skip_sum.float() / math.sqrt(len(self.residual_layers))
        x = F.relu(self.skip_projection(x))
        return self.output_projection(x)[:, 0]


def diffwave_loss(model: DiffWave, batch, generator: Optional[torch.Generator] = None, *,
                  t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None):
    """Random-step L1 noise-prediction loss (reference ``train.py:293-333``).

    ``batch``: audio [B, T], mel [B, T // hop, n_mels] (None or absent when
    unconditional). The steps ``t`` [B] and the ``noise`` [B, T] are drawn
    from ``generator`` unless given (under a data-parallel mesh: this rank's
    rows of the global batch's draws, and the global mean). Returns ``(loss,
    {"l1_noise": loss})``.
    """
    c = model.config
    audio, mel = batch["audio"], batch.get("mel")
    B = audio.shape[0]
    if t is None:
        t = global_draw(functools.partial(torch.randint, 0, c.num_steps), (B,), generator,
                        device=audio.device)
    if noise is None:
        noise = global_draw(torch.randn, audio.shape, generator, device=audio.device)
    beta = torch.tensor(c.noise_schedule, dtype=torch.float32, device=audio.device)
    scale = torch.sqrt(torch.cumprod(1.0 - beta, dim=0)[t])[:, None]
    noisy = scale * audio + torch.sqrt(1.0 - scale ** 2) * noise
    predicted = model(noisy, t, mel)
    loss = global_mean(torch.abs(noise - predicted))
    return loss, {"l1_noise": loss}


def sampling_schedule(config: DiffWaveConfig, fast_sampling: bool):
    """Host-side schedule alignment (reference ``inference.py:75-103``).

    Returns (T, c1, c2, sigma) numpy arrays ordered for the reverse loop
    (step N-1 first).
    """
    training = np.array(config.noise_schedule)
    inference = (np.array(config.inference_noise_schedule)
                 if fast_sampling else training)
    talpha_cum = np.cumprod(1 - training)
    beta = inference
    alpha = 1 - beta
    alpha_cum = np.cumprod(alpha)

    T = []
    for s in range(len(inference)):
        for t in range(len(training) - 1):
            if talpha_cum[t + 1] <= alpha_cum[s] <= talpha_cum[t]:
                twiddle = (talpha_cum[t] ** 0.5 - alpha_cum[s] ** 0.5) / (
                    talpha_cum[t] ** 0.5 - talpha_cum[t + 1] ** 0.5)
                T.append(t + twiddle)
                break
    T = np.array(T, np.float32)

    n = np.arange(len(alpha))
    c1 = 1.0 / alpha ** 0.5
    c2 = beta / (1 - alpha_cum) ** 0.5
    sigma = np.where(
        n > 0,
        ((1.0 - np.concatenate([[1.0], alpha_cum[:-1]])) /
         (1.0 - alpha_cum) * beta) ** 0.5,
        0.0)
    rev = slice(None, None, -1)
    return (T[rev], c1[rev].astype(np.float32), c2[rev].astype(np.float32),
            sigma[rev].astype(np.float32))


@torch.no_grad()
def reverse_sample(model: DiffWave, spectrogram: Optional[torch.Tensor] = None, *,
                   fast_sampling: bool = False, audio_len: Optional[int] = None,
                   generator: Optional[torch.Generator] = None,
                   audio0: Optional[torch.Tensor] = None,
                   noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """mel → waveform by the reverse process (reference
    ``inference.py:106-143``): a loop over the 6 (``fast_sampling``) or 50
    steps, each ``audio = c1 (audio - c2 eps) + σ z``, clipped to [-1, 1].

    The start ``audio0`` [B, length] and the per-step noise ``noise`` (one
    [B, length] tensor a step, drawn at every step as JAX draws it) come from
    ``generator`` unless given. Returns f32 audio [B, length].
    """
    c = model.config
    T, c1, c2, sigma = sampling_schedule(c, fast_sampling)
    if c.unconditional:
        B, length = 1, audio_len or c.audio_len
        device = next(model.parameters()).device
    else:
        B, length = spectrogram.shape[0], c.hop_length * spectrogram.shape[1]
        device = spectrogram.device
    if audio0 is None:
        audio0 = torch.randn((B, length), generator=generator, device=device)
    audio = audio0.float()
    for n in range(len(T)):
        eps = model(audio, torch.full((B,), float(T[n]), device=device), spectrogram).float()
        audio = float(c1[n]) * (audio - float(c2[n]) * eps)
        z = (noise[n] if noise is not None
             else torch.randn((B, length), generator=generator, device=device))
        audio = torch.clamp(audio + float(sigma[n]) * z, -1.0, 1.0)
    return audio
