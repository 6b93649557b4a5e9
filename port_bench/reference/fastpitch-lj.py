"""Reference of the ``fastpitch-lj`` configuration: the character front
end, FastPitch inference and the HiFi-GAN v1 generator, plain PyTorch in
the arithmetic of :class:`~.nets.Arith`."""

from __future__ import annotations

import torch
from torch.nn import functional as F

from .nets import Arith, FastPitchRef, GeneratorRef, round_durations
from .text import encode as _encode

__all__ = ["build", "encode", "durations", "decode", "vocode", "round_durations"]


def build(cfg: dict, device) -> dict:
    """The reference's networks (parameters unset), keyed as the weights'
    prefixes."""
    return {"fastpitch": FastPitchRef(cfg["fastpitch"]).to(device).eval(),
            "vocoder": GeneratorRef(cfg["vocoder"]).to(device).eval()}


def encode(cfg: dict, text: str):
    return _encode(text, cfg["symbol_set"], tuple(cfg["text_cleaners"]))


@torch.no_grad()
def log_duration_stats(cfg: dict, weights: dict, device, texts):
    """The mean and the standard deviation, over every token of ``texts``, of
    the duration head's output under ``weights`` (the ``fastpitch.``-prefixed
    leaves), in f32."""
    net = FastPitchRef(cfg["fastpitch"]).to(device).eval()
    own = dict(net.named_parameters())
    for name, value in weights.items():
        if name.startswith("fastpitch."):
            own[name[len("fastpitch."):]].data.copy_(value)
    a = Arith("f32")
    with a.flags():
        outs = [net.log_durations(a, torch.as_tensor(encode(cfg, t), device=device))
                for t in texts]
    outs = torch.cat(outs)
    return float(outs.mean()), float(outs.std())


@torch.no_grad()
def durations(nets: dict, a: Arith, ids: torch.Tensor, width: int):
    """``(encoder output, predicted durations)`` of one utterance."""
    with a.flags():
        return nets["fastpitch"].durations(a, ids, width)


@torch.no_grad()
def decode(nets: dict, a: Arith, enc, reps, max_len: int):
    with a.flags():
        return nets["fastpitch"].decode(a, enc, reps, max_len)


@torch.no_grad()
def vocode(nets: dict, a: Arith, mel: torch.Tensor, frames: int) -> torch.Tensor:
    """Audio of ``mel [n, n_mel]`` zero-padded to the batch's ``frames``,
    cut back to ``n`` frames' samples."""
    n = mel.shape[0]
    hop = 1
    for u in nets["vocoder"].rates:
        hop *= u
    with a.flags():
        audio = nets["vocoder"](a, F.pad(mel, (0, 0, 0, frames - n))[None])[0]
    return audio[:n * hop]
