"""Multiply-add counts of the layers the configurations share, two FLOPs a
multiply-add, as ``torch.utils.flop_counter`` counts matrix products and
convolutions (nothing else counts: norms, activations, FFTs and gathers are
left out). A conv over ``t`` output positions (the input's positions for a
transposed conv) costs ``2 · t · cout · cin/groups · k`` a row; its input
gradient and its weight gradient cost as much again each."""

from __future__ import annotations

from typing import List, Tuple

__all__ = ["conv", "generator_convs", "generator_flops"]


def conv(t: int, cin: int, cout: int, k: int, groups: int = 1) -> int:
    return 2 * t * cout * (cin // groups) * k


def generator_convs(g: dict, frames: int) -> List[Tuple[int, bool]]:
    """Every conv of the HiFi-GAN generator on ``frames`` mel frames (one
    row) as ``(flops, first)``, ``first`` for the one conv whose input is
    the mel."""
    ch = g["upsample_initial_channel"]
    out = [(conv(frames, g["num_mels"], ch, 7), True)]
    t = frames
    for i, (u, k) in enumerate(zip(g["upsample_rates"], g["upsample_kernel_sizes"])):
        co = g["upsample_initial_channel"] // 2 ** (i + 1)
        out.append((conv(t, ch, co, k), False))  # transposed: the input's positions
        t, ch = t * u, co
        for kr, dil in zip(g["resblock_kernel_sizes"], g["resblock_dilation_sizes"]):
            out += [(conv(t, ch, ch, kr), False)] * (2 * len(dil))
    out.append((conv(t, ch, 1, 7), False))
    return out


def generator_flops(g: dict, frames: int) -> int:
    """The generator's forward on one row of ``frames`` mel frames."""
    return sum(f for f, _ in generator_convs(g, frames))
