"""Faults planted in the program underneath a run, to show that the check
fails them (``tests/test_bench_faults.py`` on the CPU, ``calibrate.py`` on
the card). Each is a context manager that patches one function of the port
and restores it."""

from __future__ import annotations

import contextlib

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


FAULTS = {"state_unchanged": state_unchanged, "small_leaves_unchanged": small_leaves_unchanged,
          "half_batch_step": half_batch_step,
          "half_batch_vocoder": half_batch_vocoder, "altered_token": altered_token,
          "altered_audio": altered_audio}
