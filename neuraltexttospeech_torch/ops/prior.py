"""Beta-binomial attention prior computed on the device from the lengths.

Counterpart of ``neuraltexttospeech_tpu/ops/prior.py`` (:31-56). The prior
is a function of the two length vectors alone, so the trainer computes it
inside the step instead of shipping the batch's largest tensor from the
host (``data/prior.py`` is the host version, for ``--host-prior``):

    pmf(k; n, a, b) = C(n, k) · B(k+a, n−k+b) / B(a, b)

with ``a = s·i``, ``b = s·(M+1−i)`` for mel frame ``i ∈ [1, M]``, ``n = P``
(the text length), at ``k ∈ [0, P)``. Rows ``i > M`` and columns ``k ≥ P``
are 0, as the host collate pads them. f32 ``torch.lgamma``; within 2e-3 of
the f64 scipy pmf at LJSpeech-scale shapes.
"""

from __future__ import annotations

import torch

__all__ = ["beta_binomial_prior"]


def beta_binomial_prior(mel_lens: torch.Tensor, text_lens: torch.Tensor, mel_max: int,
                        text_max: int, scaling_factor: float = 1.0) -> torch.Tensor:
    """[B, mel_max, text_max] padded priors on the lengths' device."""
    dev = mel_lens.device
    i = torch.arange(1, mel_max + 1, dtype=torch.float32, device=dev)[None, :, None]
    k = torch.arange(text_max, dtype=torch.float32, device=dev)[None, None, :]
    m = mel_lens.float()[:, None, None]
    n = text_lens.float()[:, None, None]
    valid = (i <= m) & (k < n)
    one = torch.ones((), device=dev)
    a = scaling_factor * i
    b = torch.where(valid, scaling_factor * (m + 1.0 - i), one)
    nk = torch.where(valid, n - k, one)  # n-k >= 1 where valid
    lg = torch.lgamma
    log_pmf = (lg(n + 1.0) - lg(k + 1.0) - lg(nk + 1.0)
               + lg(k + a) + lg(nk + b) - lg(n + a + b)
               - (lg(a) + lg(b) - lg(a + b)))
    return torch.where(valid, torch.exp(log_pmf), torch.zeros((), device=dev))
