"""Length-mask helpers and ``AttrDict`` (counterpart of
``neuraltexttospeech_tpu/utils/masking.py``)."""

from __future__ import annotations

import torch

__all__ = ["mask_from_lens", "AttrDict"]


def mask_from_lens(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, max_len] bool mask (True inside the sequence)."""
    pos = torch.arange(max_len, device=lengths.device)
    return pos[None, :] < lengths[:, None].long()


class AttrDict(dict):
    """dict with attribute access (reference ``FastPitch_TF/common/utils.py``
    / ``DiffWave_TF/params.py`` AttrDict, incl. ``override``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.__dict__ = self

    def override(self, attrs):
        """Update from a dict, or from each dict of a list, tuple or set
        (None entries skipped); returns self."""
        if isinstance(attrs, dict):
            self.__dict__.update(**attrs)
        elif isinstance(attrs, (list, tuple, set)):
            for a in attrs:
                self.override(a)
        elif attrs is not None:
            raise NotImplementedError
        return self
