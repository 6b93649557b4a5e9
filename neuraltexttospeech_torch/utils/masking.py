"""Length-mask helpers (counterpart of ``neuraltexttospeech_tpu/utils/masking.py``)."""

from __future__ import annotations

import torch

__all__ = ["mask_from_lens"]


def mask_from_lens(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, max_len] bool mask (True inside the sequence)."""
    pos = torch.arange(max_len, device=lengths.device)
    return pos[None, :] < lengths[:, None].long()
