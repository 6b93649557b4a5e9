"""Tacotron 2 training: stop-token targets, the optimizer and the loss
function of the generic :class:`~..train.harness.Trainer`.

Counterpart of ``neuraltexttospeech_tpu/models/tacotron2_train.py``
(:1-101). JAX's dedicated ``tacotron2_train_step`` carries the BatchNorm
statistics beside the parameters; here they are the BatchNorms' buffers,
updated in the step's train-mode forward, so the generic ``Trainer`` (its
state dict, checkpoints and ``--resume``) carries them as it carries
TalkNet 2's. Its step is JAX's: the dropout stream from ``(seed, step)``,
the teacher-forced forward in train mode, :func:`tacotron2_loss`, then
``optax.chain(clip_by_global_norm(1.0), adamw(lr, weight_decay=1e-6))`` over
every parameter (the BatchNorm scales and the embedding included).
"""

from __future__ import annotations

import torch

from ..train.state import OptimizerConfig
from .tacotron2 import tacotron2_loss

__all__ = ["gate_targets", "optimizer_config", "loss_fn"]


def gate_targets(mel_lens: torch.Tensor, max_len: int) -> torch.Tensor:
    """1.0 at the last valid frame and beyond (the stop-token targets)."""
    pos = torch.arange(max_len, device=mel_lens.device)[None, :]
    return (pos >= (mel_lens[:, None].long() - 1)).float()


def optimizer_config(learning_rate: float = 1e-3, weight_decay: float = 1e-6,
                     grad_clip_thresh: float = 1.0) -> OptimizerConfig:
    """``optax.chain(clip_by_global_norm(c), adamw(lr, weight_decay=wd))``
    (optax's Adam defaults: b1 0.9, b2 0.999, eps 1e-8)."""
    return OptimizerConfig(optimizer="adamw", learning_rate=learning_rate, beta1=0.9,
                           beta2=0.999, eps=1e-8, weight_decay=weight_decay,
                           grad_clip_norm=grad_clip_thresh)


def loss_fn(model, batch, generator):
    """The teacher-forced forward (``model`` in train mode) and its loss;
    ``generator`` drives every dropout (None: none)."""
    out = model(batch["text"], batch["input_lens"], batch["mel"], batch["mel_lens"], generator)
    return tacotron2_loss(out, batch["mel"], gate_targets(batch["mel_lens"],
                                                          batch["mel"].shape[1]))
