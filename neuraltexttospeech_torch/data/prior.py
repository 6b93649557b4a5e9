"""Beta-binomial attention prior on the host (counterpart of
``neuraltexttospeech_tpu/data/prior.py``, a numpy/scipy copy).

Reference ``FastPitch_TF/data_function.py:49-91``. ``prepare`` writes each
item's prior to an ``.npy`` cache; ``cli/fastpitch_train.py --host-prior``
ships it with the batch instead of computing it on the device
(``ops/prior.py``).
"""

from __future__ import annotations

import functools

import numpy as np
from scipy import ndimage
from scipy.stats import betabinom

__all__ = ["beta_binomial_prior_distribution", "BetaBinomialInterpolator"]


@functools.lru_cache(maxsize=256)
def _prior_cached(phoneme_count: int, mel_count: int, scaling_factor: float):
    P, M = phoneme_count, mel_count
    x = np.arange(P)
    out = np.empty((M, P), dtype=np.float64)
    for i in range(1, M + 1):
        a, b = scaling_factor * i, scaling_factor * (M + 1 - i)
        out[i - 1] = betabinom(P, a, b).pmf(x)
    return out.astype(np.float32)


def beta_binomial_prior_distribution(
    phoneme_count: int, mel_count: int, scaling_factor: float = 1.0
) -> np.ndarray:
    """[mel_count, phoneme_count] prior — row i is BetaBinom(P, i, M+1-i).pmf."""
    return _prior_cached(int(phoneme_count), int(mel_count), float(scaling_factor))


class BetaBinomialInterpolator:
    """Cache priors at rounded sizes and zoom-interpolate
    (reference ``data_function.py:49-77``)."""

    def __init__(self, round_mel_len_to: int = 100, round_text_len_to: int = 20):
        self.round_mel_len_to = round_mel_len_to
        self.round_text_len_to = round_text_len_to

    @staticmethod
    def _round(val: int, to: int) -> int:
        return max(1, int(np.round((val + 1) / to))) * to

    def __call__(self, mel_len: int, text_len: int) -> np.ndarray:
        bw = self._round(mel_len, self.round_mel_len_to)
        bh = self._round(text_len, self.round_text_len_to)
        ret = ndimage.zoom(
            beta_binomial_prior_distribution(bh, bw),
            zoom=(mel_len / bw, text_len / bh), order=1,
        )
        assert ret.shape == (mel_len, text_len), ret.shape
        return ret.astype(np.float32)
