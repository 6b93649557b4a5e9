"""Reference of the ``hifigan-v1`` configuration: the GAN step of jik876's
``train.py`` (generator with weight norm, MPD, MSD with spectral norm on its
first scale, LSGAN and feature-matching losses, 45 · L1 of the log-mels,
three Adams with an exponential learning-rate decay) in plain PyTorch."""

from __future__ import annotations

from typing import Dict, List

import torch

from .nets import Adam, Arith, GeneratorRef, MPDRef, MSDRef, gan_losses, leaf_norms

__all__ = ["build", "first_steps"]


def build(cfg: dict, device) -> dict:
    return {"gen": GeneratorRef(cfg["hifigan"], weight_norm=True).to(device),
            "mpd": MPDRef().to(device), "msd": MSDRef().to(device)}


def _load(nets, w: Dict[str, torch.Tensor]):
    tensors = {}
    for k, net in nets.items():
        tensors.update({f"{k}.{n}": t for n, t in net.named_parameters()})
        tensors.update({f"{k}.{n}": t for n, t in net.named_buffers() if n.endswith(".u")})
    if sorted(tensors) != sorted(w):
        raise KeyError(f"the reference's leaves differ from the program's: "
                       f"{sorted(set(tensors) ^ set(w))[:4]}")
    with torch.no_grad():
        for n, v in w.items():
            tensors[n].copy_(v)


def first_steps(cfg: dict, mix: dict, seed: int, device, batches: torch.Tensor, arith: str,
                init_weights, leaves) -> dict:
    """Three GAN steps from the seeded weights on ``batches [3, B, S, 1]``:
    ``losses`` (per step, generator and discriminator), ``grad`` (each
    leaf's first gradient norm), ``update`` (each leaf's change after the
    three steps)."""
    h = cfg["hifigan"]
    a = Arith(arith)
    nets = build(cfg, device)
    _load(nets, init_weights(cfg, leaves, seed, device))
    params = {f"{k}.{n}": p for k, net in nets.items() for n, p in net.named_parameters()}
    start = {k: p.detach().clone() for k, p in params.items()}
    opts = [Adam(net.parameters(), h["adam_b1"], h["adam_b2"]) for net in nets.values()]
    losses: List[List[float]] = []
    grad = None
    with a.flags():
        for i in range(3):
            for p in params.values():
                p.grad = None
            g_loss, d_loss = gan_losses(a, nets["gen"], nets["mpd"], nets["msd"],
                                        batches[i][..., 0], h)
            (g_loss + d_loss).backward()
            losses.append([float(g_loss.detach()), float(d_loss.detach())])
            if i == 0:
                grad = leaf_norms({k: (p.grad if p.grad is not None else torch.zeros_like(p))
                               for k, p in params.items()})
            lr = h["learning_rate"] * h["lr_decay"] ** (i / int(mix["steps_per_epoch"]))
            for opt in opts:
                opt.step(lr)
    update = leaf_norms({k: p.detach() - start[k] for k, p in params.items()})
    return {"losses": losses, "grad": grad, "update": update}
