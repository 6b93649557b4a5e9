"""FastPitch losses: masked MSEs, the CTC forward-sum alignment loss and the
binarization KL (counterpart of ``neuraltexttospeech_tpu/models/fastpitch_loss.py``,
:39-143).

The CTC is ``F.ctc_loss(reduction="none")`` over the same padded, masked,
log-softmaxed logits as JAX's ``optax.ctc_loss``, blank 0 and targets
``1..T_text``, then divided by ``max(out_lens, 1)`` and averaged
(``reduction="mean"`` would divide by the target lengths). The targets are
int64 on the logits' device, so on the card PyTorch runs its native CTC
kernel, not cuDNN's. It reads the lengths on the host, one device-to-host
copy a call. An alignment that cannot fit (fewer mel frames than text
positions) gives an infinite loss here, where optax's log-zero of -1e5 gives
a large finite one. Under a data-parallel mesh every mean and masked count
is the global batch's (``parallel.mesh.global_mean``, ``global_count``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
from torch.nn import functional as F

from ..parallel.mesh import global_count, global_mean
from ..utils.masking import mask_from_lens

__all__ = ["FastPitchLossConfig", "fastpitch_loss", "attention_ctc_loss",
           "attention_binarization_loss"]


@dataclasses.dataclass(frozen=True)
class FastPitchLossConfig:
    dur_predictor_loss_scale: float = 0.1
    pitch_predictor_loss_scale: float = 0.1
    energy_predictor_loss_scale: float = 0.1
    attn_loss_scale: float = 1.0
    attn_kl_scale: float = 1.0
    blank_logprob: float = -1.0


def attention_ctc_loss(attn_logprob: torch.Tensor, in_lens: torch.Tensor,
                       out_lens: torch.Tensor, blank_logprob: float = -1.0) -> torch.Tensor:
    """CTC forward-sum over the aligner's log-probabilities [B, T_mel, T_text]:
    a blank class of constant ``blank_logprob`` at index 0, classes past each
    text length masked, targets the strictly increasing ``1..text_len``."""
    B, T_mel, T_text = attn_logprob.shape
    dev = attn_logprob.device
    logits = F.pad(attn_logprob, (1, 0), value=blank_logprob)  # [B, T_mel, T_text+1]
    class_mask = torch.arange(T_text + 1, device=dev)[None, None, :] > in_lens[:, None, None]
    logits = torch.where(class_mask, torch.full((), -1e9, device=dev), logits)
    log_probs = torch.log_softmax(logits, dim=-1)
    targets = torch.arange(1, T_text + 1, device=dev).expand(B, T_text)
    per_example = F.ctc_loss(log_probs.transpose(0, 1), targets, out_lens.long(),
                             in_lens.long(), blank=0, reduction="none")
    return global_mean(per_example / torch.clamp_min(out_lens.float(), 1.0))


def attention_binarization_loss(hard_attention: torch.Tensor, soft_attention: torch.Tensor,
                                eps: float = 1e-12) -> torch.Tensor:
    """KL between the binarized and the soft attention."""
    log_soft = torch.log(torch.clamp_min(soft_attention, eps))
    num = torch.sum(torch.where(hard_attention == 1.0, log_soft,
                                torch.zeros((), device=log_soft.device)))
    return -num / torch.clamp_min(global_count(torch.sum(hard_attention)), 1.0)


def _masked_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean squared error over the masked elements; a mask that broadcasts
    over trailing feature axes counts each broadcast element."""
    sq = torch.square(pred - target) * mask
    n = global_count(torch.sum(mask.expand(sq.shape)))
    return torch.sum(sq) / torch.clamp_min(n, 1.0)


def fastpitch_loss(model_out, mel_target: torch.Tensor, input_lens: torch.Tensor,
                   output_lens: torch.Tensor,
                   config: FastPitchLossConfig = FastPitchLossConfig(),
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss and the per-term metrics, as JAX's ``fastpitch_loss``."""
    o = model_out
    dur_target = o.attn_hard_dur
    dur_mask = mask_from_lens(input_lens, dur_target.shape[1]).float()
    dur_pred_loss = _masked_mse(o.log_dur_pred, torch.log(dur_target.float() + 1.0), dur_mask)
    mel_mask = mask_from_lens(output_lens, mel_target.shape[1])[..., None].float()
    mel_loss = _masked_mse(o.mel_out, mel_target, mel_mask)
    pitch_loss = _masked_mse(o.pitch_pred, o.pitch_tgt, dur_mask[:, None, :])
    if o.energy_pred is not None:
        energy_loss = _masked_mse(o.energy_pred, o.energy_tgt, dur_mask)
    else:
        energy_loss = torch.zeros((), device=mel_target.device)
    attn_loss = attention_ctc_loss(o.attn_logprob, input_lens, output_lens, config.blank_logprob)
    kl_loss = attention_binarization_loss(o.attn_hard, o.attn_soft)
    loss = (mel_loss
            + dur_pred_loss * config.dur_predictor_loss_scale
            + pitch_loss * config.pitch_predictor_loss_scale
            + energy_loss * config.energy_predictor_loss_scale
            + attn_loss * config.attn_loss_scale
            + kl_loss * config.attn_kl_scale)
    meta = {
        "loss": loss,
        "mel_loss": mel_loss,
        "duration_predictor_loss": dur_pred_loss,
        "pitch_loss": pitch_loss,
        "energy_loss": energy_loss,
        "attn_loss": attn_loss,
        "kl_loss": kl_loss,
        "dur_error": torch.sum(torch.abs(o.dur_pred - dur_target) * dur_mask)
        / torch.clamp_min(global_count(torch.sum(dur_mask)), 1.0),
    }
    return loss, meta
