"""Reference of the stand-in ``toy-vocoder`` configuration: each mel frame
through two plain products and a tanh, in the arithmetic of
:class:`~.nets.Arith`."""

from __future__ import annotations

import torch

from .nets import Arith

__all__ = ["leaves", "forward"]


def leaves(cfg: dict):
    """``(name, shape)`` of the weights, named as the program's layers."""
    t = cfg["toy"]
    return [("0.bias", (t["hidden"],)), ("0.weight", (t["hidden"], t["n_mels"])),
            ("2.bias", (t["hop"],)), ("2.weight", (t["hop"], t["hidden"]))]


@torch.no_grad()
def forward(w: dict, x: torch.Tensor, arith: Arith = Arith()) -> torch.Tensor:
    with Arith.flags():
        h = torch.tanh(arith.q(x) @ arith.q(w["0.weight"]).T + w["0.bias"])
        return arith.q(h) @ arith.q(w["2.weight"]).T + w["2.bias"]
