"""Faults planted in the program underneath a run, to show that the check
fails them (``tests/test_bench_faults.py`` on the CPU, ``calibrate.py`` on
the card). Each is a context manager that patches one function of the port
and restores it."""

from __future__ import annotations

import contextlib
import dataclasses

__all__ = ["FAULTS"]


@contextlib.contextmanager
def _patched(owner, name, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def state_unchanged():
    """Every optimizer step leaves the parameters as they were."""
    import torch

    return _patched(torch.optim.Adam, "step", lambda orig: lambda self, closure=None: None)


def small_leaves_unchanged():
    """Every optimizer step leaves the one-dimensional parameters (the
    biases) as they were and steps the rest."""
    import torch

    def make(orig):
        def step(self, closure=None):
            small = [p for g in self.param_groups for p in g["params"] if p.dim() == 1]
            before = [p.detach().clone() for p in small]
            out = orig(self, closure)
            with torch.no_grad():
                for p, b in zip(small, before):
                    p.copy_(b)
            return out
        return step

    return _patched(torch.optim.Adam, "step", make)


def half_batch_step():
    """The GAN step takes the first half of its batch: its means are over
    the rest."""
    from neuraltexttospeech_torch.models.hifigan_gan import HiFiGANTrainer

    def make(orig):
        def step(self, batch):
            return orig(self, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
        return step

    return _patched(HiFiGANTrainer, "train_step", make)


def half_batch_vocoder():
    """The vocoder leaves out the second half of each batch (zeros there)."""
    from neuraltexttospeech_torch.cli import hifigan_infer

    def make(orig):
        def vocode(generator, mel, dtype=None):
            out = orig(generator, mel, dtype).clone()
            out[(out.shape[0] + 1) // 2:] = 0.0
            return out
        return vocode

    return _patched(hifigan_infer, "vocode", make)


def altered_token():
    """The front end returns one id changed in every utterance."""
    from neuraltexttospeech_torch.text.processing import TextProcessing

    def make(orig):
        def encode_text(self, text, return_all=False):
            ids = list(orig(self, text))
            ids[len(ids) // 2] = ids[len(ids) // 2] % 60 + 1
            return ids
        return encode_text

    return _patched(TextProcessing, "encode_text", make)


def altered_audio():
    """The vocoder's first output sample of every batch is changed."""
    from neuraltexttospeech_torch.cli import hifigan_infer

    def make(orig):
        def vocode(generator, mel, dtype=None):
            out = orig(generator, mel, dtype).clone()
            out[:, 0] += 0.5
            return out
        return vocode

    return _patched(hifigan_infer, "vocode", make)


def lamb_state_unchanged():
    """The port's optimizer (``train/state.py``) takes its gradients and
    never updates: every parameter and moment stays as it was."""
    from neuraltexttospeech_torch.train import state

    return _patched(state.Optimizer, "_update", lambda orig: lambda self, grads: None)


def lamb_without_trust_ratio():
    """LAMB without its trust ratio: the update is AdamW's (the same moments,
    the same weight decay), not scaled per leaf by ``|p| / |u|``."""
    from neuraltexttospeech_torch.train import state

    def make(orig):
        def update(self, grads):
            config = self.config
            if config.optimizer == "lamb":
                self.config = dataclasses.replace(config, optimizer="adamw")
            try:
                return orig(self, grads)
            finally:
                self.config = config
        return update

    return _patched(state.Optimizer, "_update", make)


def mas_shifted():
    """MAS's path with one frame moved across one token boundary in the
    batch's first utterance: the first token with two frames or more gives
    its first frame to the token before it (token 0 its last to token 1)."""
    from neuraltexttospeech_torch.models import fastpitch

    def make(orig):
        def maximum_path(log_attn, in_lens, out_lens, *args, **kwargs):
            path = orig(log_attn, in_lens, out_lens, *args, **kwargs).clone()
            dur = path[0].sum(0).long().tolist()
            j = next(j for j, d in enumerate(dur) if d >= 2)
            if j:
                f = sum(dur[:j])
                path[0, f, j], path[0, f, j - 1] = 0.0, 1.0
            else:
                path[0, dur[0] - 1, 0], path[0, dur[0] - 1, 1] = 0.0, 1.0
            return path
        return maximum_path

    return _patched(fastpitch, "maximum_path", make)


def dropout_skipped():
    """The predictors' dropout (``nn/layers.py::ConvReLUNorm``) applies no
    mask and draws none: each returns its input."""
    # nn/transformer.py binds layers.dropout when it is first imported: import it
    # first, so that only the predictors' calls meet the fault
    from neuraltexttospeech_torch.nn import layers, transformer  # noqa: F401

    return _patched(layers, "dropout", lambda orig: lambda x, p, generator=None, **kw: x)


def half_rows_loss():
    """The FastPitch loss averages over the first half of its batch's rows
    alone; the forward, its dropout and MAS still run on every row, so what
    the run records fits its batch."""
    from neuraltexttospeech_torch.cli import fastpitch_train

    def make(orig):
        def loss(out, mel, in_lens, out_lens, *args, **kwargs):
            half = mel.shape[0] // 2
            out = type(out)(*(None if v is None else v[:half] for v in out))
            return orig(out, mel[:half], in_lens[:half], out_lens[:half], *args, **kwargs)
        return loss

    return _patched(fastpitch_train, "fastpitch_loss", make)


def accumulation_drops_half():
    """The optimizer's accumulation (``train/state.py``) drops the gradients
    of the first half of each update's micro-steps: the update's gradient is
    the mean over the second half, half of the batch left out and the mean
    taken over the rest."""
    import torch

    from neuraltexttospeech_torch.train import state

    def make(orig):
        def step(self, grads):
            k = self.config.grad_accum_steps
            if k == 1:
                return orig(self, grads)
            if self.mini_step < k // 2:
                self.mini_step += 1
                return False
            with torch.no_grad():  # the running mean over the kept micro-steps
                grads = [torch.zeros_like(p) if g is None else g
                         for p, g in zip(self.params, grads)]
                diff = torch._foreach_sub(grads, self.acc)
                torch._foreach_div_(diff, float(self.mini_step - k // 2 + 1))
                torch._foreach_add_(self.acc, diff)
                self.mini_step = (self.mini_step + 1) % k
                if self.mini_step:
                    return False
                self._update(self.acc)
                torch._foreach_zero_(self.acc)
            return True
        return step

    return _patched(state.Optimizer, "step", make)


def half_batch_train_step():
    """The trainer's step takes the first half of its batch's rows: every
    mean is over the rest. The run's records (dropout masks, MAS paths) then
    no longer fit the batch the reference is given."""
    from neuraltexttospeech_torch.train.harness import Trainer

    def make(orig):
        def step(self, batch):
            return orig(self, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
        return step

    return _patched(Trainer, "train_step", make)


FAULTS = {"state_unchanged": state_unchanged, "small_leaves_unchanged": small_leaves_unchanged,
          "half_batch_step": half_batch_step,
          "half_batch_vocoder": half_batch_vocoder, "altered_token": altered_token,
          "altered_audio": altered_audio, "lamb_state_unchanged": lamb_state_unchanged,
          "lamb_without_trust_ratio": lamb_without_trust_ratio, "mas_shifted": mas_shifted,
          "dropout_skipped": dropout_skipped, "half_rows_loss": half_rows_loss,
          "accumulation_drops_half": accumulation_drops_half,
          "half_batch_train_step": half_batch_train_step}
