"""Monotonic alignment search (counterpart of ``neuraltexttospeech_tpu/ops/mas.py``).

:func:`maximum_path` is batched width-1 MAS on the tensor's device: the CUDA
kernel of ``ops/mas_kernel.py`` on the card, its plain twin on the CPU.
:func:`b_mas` is the reference's ``[B, 1, T_mel, T_text]`` API
(``FastPitch_TF/alignment.py:62-68``) and :func:`mas_width1_numpy` the host
oracle with the reference's exact semantics (``alignment.py:33-58``), which
the tests hold both against.
"""

from __future__ import annotations

import numpy as np
import torch

from .mas_kernel import maximum_path

__all__ = ["maximum_path", "b_mas", "mas_width1_numpy"]


def b_mas(b_log_attn_map: torch.Tensor, in_lens: torch.Tensor, out_lens: torch.Tensor,
          width: int = 1) -> torch.Tensor:
    """[B, 1, T_mel, T_text] -> the same-shaped hard attention."""
    if width != 1:
        raise ValueError("only width 1 is supported, as in the reference")
    return maximum_path(b_log_attn_map[:, 0], in_lens, out_lens)[:, None]


def mas_width1_numpy(log_attn_map: np.ndarray) -> np.ndarray:
    """Host numpy oracle for one utterance at full lengths, in float64."""
    neg_inf = -np.inf
    log_p = log_attn_map.astype(np.float64).copy()
    log_p[0, 1:] = neg_inf
    T_mel, T_text = log_p.shape
    for i in range(1, T_mel):
        prev = log_p[i - 1]
        shifted = np.concatenate([[neg_inf], prev[:-1]])
        log_p[i] += np.maximum(shifted, prev)
    opt = np.zeros_like(log_p, dtype=np.float32)
    j = T_text - 1
    for i in range(T_mel - 1, 0, -1):
        opt[i, j] = 1.0
        if j > 0 and log_p[i - 1, j - 1] >= log_p[i - 1, j]:
            j -= 1
    opt[0, j] = 1.0
    return opt
