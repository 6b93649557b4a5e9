"""Seeded ``torch.Generator``s, the port's explicit randomness: the
trainer's per-step streams and the samplers' per-utterance ones."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["seeded_generator"]


def seeded_generator(device, *entropy: int) -> torch.Generator:
    """A generator on ``device`` seeded from the integers ``entropy``."""
    state = np.random.SeedSequence(list(entropy)).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) << 32 | int(state[1]))
    return gen
