"""Counts of the ``hifigan-v1`` configuration's GAN step: its FLOPs (every
conv and matrix product of the generator, the MPD and the MSD, forward and
backward, the mel projections and the spectral norm's power step, from the
published widths) and the roofline bounds of the step's kernel calls (B1
three times, B2 ninety), from the frozen bound functions."""

from __future__ import annotations

from typing import List, Tuple

from ..yardstick.bounds import MelConfig, logmel_bound_ms, msd_tap_shapes, tap_dots_bound_ms
from ._layers import conv, generator_convs

__all__ = ["step_flops", "b1_bound_ms", "b2_bound_ms", "mel_frames"]

MPD_PERIODS = (2, 3, 5, 7, 11)
MPD_CHANNELS = (1, 32, 128, 512, 1024, 1024)
MPD_STRIDES = (3, 3, 3, 3, 1)
MSD_SPECS = ((128, 15, 1, 1), (128, 41, 2, 4), (256, 41, 2, 16), (512, 41, 4, 16),
             (1024, 41, 4, 16), (1024, 41, 1, 16), (1024, 5, 1, 1))


def mpd_convs(batch: int, samples: int) -> List[Tuple[int, bool]]:
    """Each MPD conv on ``batch`` wavs as ``(flops, first)``."""
    out = []
    for p in MPD_PERIODS:
        t = -(-samples // p)
        for ci, co, s in zip(MPD_CHANNELS, MPD_CHANNELS[1:], MPD_STRIDES):
            t = -(-t // s)
            out.append((conv(batch * p * t, ci, co, 5), ci == 1))
        out.append((conv(batch * p * t, 1024, 1, 3), False))
    return out


def msd_convs(batch: int, samples: int) -> List[Tuple[int, bool]]:
    out, n = [], samples
    for _ in range(3):
        t, ci = n, 1
        for co, k, s, g in MSD_SPECS:
            t = -(-t // s)
            out.append((conv(batch * t, ci, co, k, g), ci == 1))
            ci = co
        out.append((conv(batch * t, 1024, 1, 3), False))
        n = -(-n // 2)
    return out


def spectral_norm_flops() -> int:
    """The first scale's power step: three calls a step (the generator's
    lane without gradient, the real and the fake pass with it), each
    ``u·W``, ``v·Wᵀ``, ``u·W·vᵀ``; the two passes with gradient
    differentiate ``σ`` through ``u·W·vᵀ``."""
    total, ci = 0, 1
    for co, k, s, g in MSD_SPECS + ((1, 3, 1, 1),):
        cin = 1024 if co == 1 else ci
        r = cin // g * k
        total += 3 * (6 * co * r + 2 * r) + 2 * (2 * r + 2 * co * r)
        ci = co
    return total


def mel_frames(cfg: dict, samples: int) -> int:
    h = cfg["hifigan"]
    return 1 + (samples + h["n_fft"] - h["hop_size"] - h["win_size"]) // h["hop_size"]


def step_flops(cfg: dict, batch: int, samples: int) -> int:
    """One GAN step: the generator forward and its input and weight
    gradients (the first conv's input, the mel, takes none); each
    discriminator three times forward (the generator's lane, the real and
    the fake pass), its input gradients in the generator's lane, and its
    weight and input gradients in the two passes with gradient (the first
    conv's input, the audio, takes none there)."""
    h = cfg["hifigan"]
    frames = mel_frames(cfg, samples)
    gen = sum(f * (3 if not first else 2) for f, first in generator_convs(h, frames)) * batch
    disc = 0
    for f, first in mpd_convs(batch, samples) + msd_convs(batch, samples):
        disc += 3 * f + f + 2 * (f + (0 if first else f))
    bins = h["n_fft"] // 2 + 1
    mel = 2 * batch * frames * bins * h["num_mels"] * 4  # three forwards, one input gradient
    return gen + disc + mel + spectral_norm_flops()


def b2_bound_ms(cfg: dict, batch: int, samples: int) -> float:
    """The bound of one step's 90 B2 calls: each MSD layer on the gouter
    path forward and its input gradient, for the three passes."""
    return sum(3 * (tap_dots_bound_ms(fwd)[0] + tap_dots_bound_ms(dx)[0])
               for _, _, fwd, dx in msd_tap_shapes(batch, samples))


def b1_bound_ms(cfg: dict, batch: int, samples: int) -> float:
    """The bound of one step's three B1 calls: the input log-mel (fmax) and
    the loss log-mels of the real and the generated audio (Nyquist)."""
    h = cfg["hifigan"]
    n = batch * mel_frames(cfg, samples)
    fmax_loss = h["fmax_for_loss"] if h.get("fmax_for_loss") is not None else h["sampling_rate"] / 2
    cfg_in = MelConfig(h["n_fft"], h["num_mels"], h["sampling_rate"], float(h["fmin"]),
                       float(h["fmax"]))
    cfg_loss = MelConfig(h["n_fft"], h["num_mels"], h["sampling_rate"], float(h["fmin"]),
                         float(fmax_loss))
    return logmel_bound_ms(n, cfg_in)[0] + 2 * logmel_bound_ms(n, cfg_loss)[0]
