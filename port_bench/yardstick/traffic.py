"""The one traffic generator: every mix is a data file under ``traffic/``
that this module reads.

A serving mix draws its sentences from a corpus file (one sentence a line)
split into ``strata`` equal bins by length: every run of ``strata``
consecutive sentences holds one sentence of each bin, in an order and with
picks inside the bins drawn from the run's seed, so every seed serves the
same spread of lengths. A request is ``sentences_per_request`` consecutive
sentences; one client sends the next request when the last completes.
"""

from __future__ import annotations

import pathlib
from typing import List

import numpy as np

__all__ = ["Sentences", "round_up"]


def round_up(n: int, multiple: int) -> int:
    return -(-int(n) // multiple) * multiple


class Sentences:
    """The request stream of a serving mix for one seed."""

    def __init__(self, mix: dict, seed: int, root: pathlib.Path):
        lines = [l.strip() for l in (root / mix["corpus"]).read_text(encoding="utf-8")
                 .splitlines() if l.strip()]
        order = sorted(range(len(lines)), key=lambda i: (len(lines[i]), i))
        self.lines = lines
        self.bins = np.array_split(np.asarray(order), int(mix["strata"]))
        self.per_request = int(mix["sentences_per_request"])
        self.rng = np.random.default_rng([int(seed), 0x5E47])
        self._drawn: List[str] = []

    def middles(self) -> List[str]:
        """The middle sentence of each length bin (the same for every seed)."""
        return [self.lines[int(b[len(b) // 2])] for b in self.bins]

    def _draw_block(self):
        for b in self.rng.permutation(len(self.bins)):
            self._drawn.append(self.lines[int(self.rng.choice(self.bins[b]))])

    def request(self, k: int) -> List[str]:
        """The raw texts of request ``k`` (requests are drawn in order)."""
        while len(self._drawn) < (k + 1) * self.per_request:
            self._draw_block()
        return self._drawn[k * self.per_request:(k + 1) * self.per_request]
