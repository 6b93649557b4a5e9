"""Optimizers with optax's semantics (counterpart of
``neuraltexttospeech_tpu/train/state.py``, :24-85).

:class:`Optimizer` is what ``make_optimizer`` builds in JAX:

    MultiSteps(chain(clip_by_global_norm(c), adam | adamw | lamb), k)

- **clip**: ``g · c / |g|`` over all parameters when ``|g| ≥ c`` (optax's
  form; ``clip_grad_norm_`` divides by ``|g| + 1e-6`` instead).
- **adam**: ``m̂ / (√v̂ + eps)`` with the bias corrections at the update
  count after the increment.
- **adamw**: adam's update plus ``wd · p``, decoupled from the moments.
- **lamb** (not in ``torch.optim``): adam's update plus ``wd · p``, scaled
  per parameter by ``|p| / |u|`` (1 where either norm is 0).
- the step is ``-lr · u`` with ``lr`` the schedule (constant, exponential,
  noam) at the update count before the increment; noam reads ``max(count, 1)``.
- **accumulation** over ``k`` calls: the running mean of the gradients,
  ``acc + (g - acc) / (n + 1)``; the k-th call runs the update on it and
  resets it, the others leave the parameters as they are.

Plain PyTorch optimizer code: ``torch._foreach_*`` ops over the parameter
list on the parameters' device, no host synchronisation. The learning rate
is a host float computed from the host-side count.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["OptimizerConfig", "Optimizer", "make_schedule", "global_norm"]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    optimizer: str = "adam"           # adam | adamw | lamb
    learning_rate: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.98
    eps: float = 1e-9
    weight_decay: float = 1e-6
    grad_clip_norm: Optional[float] = 1000.0
    grad_accum_steps: int = 1
    # schedule: constant | exponential | noam
    schedule: str = "constant"
    decay_rate: float = 0.999         # per decay_steps
    decay_steps: int = 1000
    warmup_steps: int = 1000          # noam warmup


def make_schedule(config: OptimizerConfig) -> Callable[[int], float]:
    """The learning rate at update count ``count`` (counted from 0)."""
    lr = config.learning_rate
    if config.schedule == "constant":
        return lambda count: lr
    if config.schedule == "exponential":
        return lambda count: (lr if count <= 0
                              else lr * config.decay_rate ** (count / config.decay_steps))
    if config.schedule == "noam":
        w = config.warmup_steps

        def noam(count):
            step = max(count, 1)
            return lr * min(step ** -0.5, step * w ** -1.5) * w ** 0.5

        return noam
    raise ValueError(f"unknown schedule {config.schedule}")


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element of every tensor."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


class Optimizer:
    """optax's ``MultiSteps(chain(clip, adam|adamw|lamb))`` over a fixed
    list of parameters, updated in place by :meth:`step`."""

    def __init__(self, params: Iterable[torch.nn.Parameter], config: OptimizerConfig):
        if config.optimizer not in ("adam", "adamw", "lamb"):
            raise ValueError(f"unknown optimizer {config.optimizer}")
        self.params: List[torch.nn.Parameter] = list(params)
        self.config = config
        self.schedule = make_schedule(config)
        self.count = 0      # inner updates made: the adam and schedule count
        self.mini_step = 0  # calls into the current accumulation
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if config.grad_accum_steps > 1 else None)

    @torch.no_grad()
    def step(self, grads: Sequence[Optional[torch.Tensor]]) -> bool:
        """Take one call's gradients (None = zero); returns whether the
        parameters were updated. The gradient tensors may be overwritten."""
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        k = self.config.grad_accum_steps
        if k > 1:
            diff = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(diff, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, diff)
            self.mini_step = (self.mini_step + 1) % k
            if self.mini_step:
                return False
            grads = self.acc
        self._update(grads)
        if k > 1:
            torch._foreach_zero_(self.acc)
        return True

    def _update(self, grads: List[torch.Tensor]):
        c = self.config
        if c.grad_clip_norm is not None:
            norm = global_norm(grads)
            scale = torch.where(norm < c.grad_clip_norm, torch.ones_like(norm),
                                c.grad_clip_norm / norm)
            grads = torch._foreach_mul(grads, scale)
        count = self.count + 1
        torch._foreach_mul_(self.mu, c.beta1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - c.beta1)
        torch._foreach_mul_(self.nu, c.beta2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - c.beta2)
        bc1 = float(1.0 - np.float32(c.beta1) ** np.float32(count))
        bc2 = float(1.0 - np.float32(c.beta2) ** np.float32(count))
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, c.eps)
        updates = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(updates, denom)
        if c.optimizer in ("adamw", "lamb"):
            torch._foreach_add_(updates, self.params, alpha=c.weight_decay)
        if c.optimizer == "lamb":
            p_norm = torch.stack(torch._foreach_norm(self.params))
            u_norm = torch.stack(torch._foreach_norm(updates))
            ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm),
                                p_norm / u_norm)
            for u, r in zip(updates, ratio.unbind()):
                u.mul_(r)
        torch._foreach_add_(self.params, updates, alpha=-self.schedule(self.count))
        self.count = count

    def state_dict(self) -> Dict:
        return {"count": self.count, "mini_step": self.mini_step, "mu": self.mu,
                "nu": self.nu, "acc": self.acc}

    def load_state_dict(self, state: Dict):
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        for name in ("mu", "nu", "acc"):
            mine = getattr(self, name)
            if (mine is None) != (state[name] is None):
                raise ValueError(f"optimizer state {name!r} does not fit this config")
            if mine is not None:
                for dst, src in zip(mine, state[name], strict=True):
                    dst.copy_(src)
