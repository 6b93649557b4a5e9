"""Synthetic audio: a frozen copy of ``chip_smoke.py::synthetic_wavs`` (the
host form, held to its origin by the tests) and its device form, which the
benchmark uses: four sines of seeded frequency (80–4000 Hz), amplitude
(0.05–0.2) and phase, plus 1 % white noise, drawn with one
``torch.Generator`` on the device."""

from __future__ import annotations

import numpy as np
import torch

SR = 22050

__all__ = ["synthetic_wavs", "synthetic_wavs_device"]


def synthetic_wavs(n, seconds, seed):
    """Sines plus noise, [n, seconds·SR] float32 in (-1, 1)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    out = np.zeros((n, t.size), np.float32)
    for i in range(n):
        for _ in range(4):
            f, a, ph = rng.uniform(80, 4000), rng.uniform(0.05, 0.2), rng.uniform(0, 2 * np.pi)
            out[i] += (a * np.sin(2 * np.pi * f * t + ph)).astype(np.float32)
        out[i] += 0.01 * rng.standard_normal(t.size).astype(np.float32)
    return out


def synthetic_wavs_device(n: int, samples: int, seed: int, device) -> torch.Tensor:
    """[n, samples] float32 on ``device``: the same recipe, drawn on the device."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    u = torch.rand(n, 4, 3, generator=gen, device=device, dtype=torch.float64)
    f = 80 + (4000 - 80) * u[..., 0]
    a = 0.05 + 0.15 * u[..., 1]
    ph = 2 * np.pi * u[..., 2]
    t = torch.arange(samples, device=device, dtype=torch.float64) / SR
    # the phase of each sine is reduced in float64, then the sine taken in float32
    arg = torch.remainder(2 * np.pi * f[..., None] * t + ph[..., None], 2 * np.pi)
    out = (a[..., None].float() * torch.sin(arg.float())).sum(1)
    return out + 0.01 * torch.randn(n, samples, generator=gen, device=device)
