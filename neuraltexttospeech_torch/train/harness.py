"""The generic training loop on one card (counterpart of
``neuraltexttospeech_tpu/train/harness.py``, :39-295).

Bring a ``loss_fn(model, batch, generator) -> (loss, metrics)``; the
:class:`Trainer` takes the gradients of every parameter, logs the raw
gradients' global norm as ``grad_norm``, and updates the parameters with the
optax-semantics :class:`~.state.Optimizer`. Each step draws its dropout from
a generator seeded from ``(seed, step)``, as JAX folds the step into its
key, so a resumed run repeats the straight run's masks.

Metrics stay on the device until they are logged (``_MetricMean``): no host
synchronisation per step. Checkpoints (``train/checkpoint.py``) hold the
step, the model, the optimizer's moments and accumulator, and whatever the
caller keeps in ``Trainer.extra_state`` (the data order's position); a
serving checkpoint of the model sits beside them when the caller says how
to write one.

``dtype=torch.bfloat16`` runs the loss function's forward in bf16
(``nn/precision.py``, the JAX package's ``dtype=bf16``); the parameters,
their gradients, the optimizer and the checkpoints stay f32.

The JAX trainer's pjit mesh and its TensorBoard writer are not here: this
trainer runs on one card, and the port depends on neither ``tensorflow``
nor ``tensorboard``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..data.prefetch import prefetch
from ..nn.precision import compute_dtype
from .checkpoint import Checkpointer
from .state import Optimizer, OptimizerConfig, global_norm

__all__ = ["TrainerConfig", "Trainer", "step_generator"]

# loss_fn(model, batch, generator) -> (loss, metrics)
LossFn = Callable[[torch.nn.Module, Dict[str, Any], Optional[torch.Generator]], Any]


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    optimizer: OptimizerConfig = OptimizerConfig()
    seed: int = 1234
    log_every: int = 50
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 1000
    max_checkpoints: int = 5


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout stream of step ``step``: a generator on ``device`` seeded
    from ``(seed, step)``."""
    state = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) << 32 | int(state[1]))
    return gen


class _MetricMean:
    """Running means of device scalars, summed lazily on the device and
    fetched only by :meth:`result`."""

    def __init__(self):
        self.totals: Dict[str, torch.Tensor] = {}
        self.counts: Dict[str, int] = {}

    def update(self, metrics: Dict[str, torch.Tensor]):
        for k, v in metrics.items():
            cur = self.totals.get(k)
            self.totals[k] = v if cur is None else cur + v
            self.counts[k] = self.counts.get(k, 0) + 1

    def result(self) -> Dict[str, float]:
        return {k: float(self.totals[k]) / max(self.counts[k], 1) for k in self.totals}

    def reset(self):
        self.totals.clear()
        self.counts.clear()


class Trainer:
    """One-card trainer: a loss function, a model, an optimizer config."""

    def __init__(self, loss_fn: LossFn, model: torch.nn.Module,
                 config: TrainerConfig = TrainerConfig(), device=None,
                 serving: Optional[Callable[[], tuple]] = None,
                 dtype: Optional[torch.dtype] = None):
        """``serving()`` returns ``(model_name, config, state_dict, frontend)``
        for the serving checkpoint saved beside each train state; ``dtype``
        is the loss function's compute dtype (None: f32)."""
        self.config = config
        self.dtype = dtype
        self.device = torch.device(device) if device is not None else \
            next(model.parameters()).device
        self.model = model.to(self.device)
        self._loss_fn = loss_fn
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.optimizer = Optimizer(self.params, config.optimizer)
        self.step = 0
        self.metrics = _MetricMean()
        self.serving = serving
        self.extra_state: Dict[str, Any] = {}
        self.checkpointer = (Checkpointer(config.checkpoint_dir, config.max_checkpoints,
                                          config.checkpoint_every)
                             if config.checkpoint_dir else None)

    # ------------------------------------------------------------ state

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: Dict[str, Any]):
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])

    def resume(self) -> Optional[Dict[str, Any]]:
        """Restore the newest checkpoint, if any; returns its whole state
        (with whatever the caller saved beside the trainer's), else None."""
        if self.checkpointer is None or self.checkpointer.latest_step() is None:
            return None
        state = self.checkpointer.restore()
        self.load_state_dict(state["trainer"])
        return state

    def save(self, force: bool = True) -> bool:
        """Write checkpoint ``step`` (unless it exists, or is off the
        interval without ``force``), with ``extra_state`` beside the
        trainer's state."""
        if self.checkpointer is None:
            return False
        return self.checkpointer.save(
            self.step, {"trainer": self.state_dict(), **self.extra_state},
            serving=self.serving() if self.serving is not None else None, force=force)

    # ------------------------------------------------------------- steps

    def train_step(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One step; returns the metrics as device scalars."""
        gen = step_generator(self.config.seed, self.step, self.device)
        with compute_dtype(self.dtype):
            loss, metrics = self._loss_fn(self.model, batch, gen)
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.setdefault("loss", loss.detach())
        metrics["grad_norm"] = global_norm(grads)
        self.optimizer.step(grads)
        self.step += 1
        return metrics

    def device_iter(self, batches: Iterable[Dict[str, Any]]):
        """The batches with their arrays on the trainer's device, collated
        and copied by a background thread while the current step runs."""
        return prefetch(batches, self.device)

    def fit_epoch(self, batches: Iterable[Dict[str, Any]], *, epoch: int = 0,
                  log: Callable[[str], None] = print,
                  on_step: Optional[Callable[[Dict[str, Any]], None]] = None,
                  ) -> Dict[str, float]:
        """Train over ``batches``; returns the epoch's metric means and
        ``steps_per_sec``. ``on_step(batch)`` runs after each step, before
        its checkpoint."""
        self.metrics.reset()
        t0, n = time.perf_counter(), 0
        for batch in batches:
            self.metrics.update(self.train_step(batch))
            n += 1
            if on_step is not None:
                on_step(batch)
            if self.step % self.config.log_every == 0:
                means = self.metrics.result()
                log(f"epoch {epoch} step {self.step} "
                    + " ".join(f"{k}={v:.4f}" for k, v in sorted(means.items()))
                    + f" steps/s={n / (time.perf_counter() - t0):.2f}")
            if self.checkpointer is not None and self.step % self.config.checkpoint_every == 0:
                self.save(force=False)
        if n == 0:
            print("WARNING: fit_epoch() saw 0 batches — dataset smaller than the batch "
                  "size? lower -bs or pass drop_last=False", flush=True)
        means = self.metrics.result()
        means["steps_per_sec"] = n / max(time.perf_counter() - t0, 1e-9)
        return means

    @torch.no_grad()
    def evaluate(self, loss_fn_eval: LossFn, batches: Iterable[Dict[str, Any]]
                 ) -> Dict[str, float]:
        """Metric means of ``loss_fn_eval`` over ``batches``, without
        gradients, each batch with the same fixed dropout generator (JAX
        evaluates with ``PRNGKey(0)``)."""
        tracker = _MetricMean()
        n = 0
        for batch in batches:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(0)
            with compute_dtype(self.dtype):
                tracker.update(loss_fn_eval(self.model, batch, gen)[1])
            n += 1
        if n == 0:
            print("WARNING: evaluate() saw 0 batches — validation set smaller than the "
                  "batch size? pass drop_last=False", flush=True)
        return tracker.result()
