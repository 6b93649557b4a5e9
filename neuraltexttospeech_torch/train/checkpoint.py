"""Checkpoints of a training run: save every N steps, keep the newest few, resume.

Counterpart of ``neuraltexttospeech_tpu/train/checkpoint.py`` (orbax) with
``torch.save``. A checkpoint is a directory ``<root>/<step>/`` holding
``train_state.pt`` (whatever state dict the trainer gives: step, modules,
buffers, optimizer states) and, when the run passes one, a serving
checkpoint of its model (``model.pt`` + ``model_config.json``, the format of
``models/registry.py``) that the inference CLIs load. A directory is
written under a temporary name and renamed, so a cut save leaves no
checkpoint behind; saving a step that exists does nothing.
"""

from __future__ import annotations

import os
import pathlib
import shutil
from typing import Any, List, Optional

import torch

from ..models.registry import WEIGHTS_FILE, save_checkpoint
from ..parallel.distributed import writes_files

__all__ = ["Checkpointer", "checkpoint_steps", "checkpoint_dir"]

STATE_FILE = "train_state.pt"


def checkpoint_steps(directory) -> List[int]:
    """The steps of the checkpoints under ``directory``, oldest first (none
    when it does not exist)."""
    d = pathlib.Path(directory)
    return sorted(int(p.name) for p in d.iterdir()
                  if p.is_dir() and p.name.isdigit()) if d.is_dir() else []


def checkpoint_dir(path) -> pathlib.Path:
    """The serving checkpoint dir of ``path``: itself when it holds
    ``model.pt``, else the newest numbered step under it or under its
    ``checkpoints``."""
    p = pathlib.Path(path)
    if (p / WEIGHTS_FILE).exists():
        return p
    root = p if p.name == "checkpoints" else p / "checkpoints"
    steps = checkpoint_steps(root)
    if not steps:
        raise FileNotFoundError(f"no checkpoint under {path}")
    return root / str(steps[-1])


class Checkpointer:
    def __init__(self, directory, max_to_keep: int = 5, save_interval_steps: int = 1):
        self.directory = pathlib.Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps

    def all_steps(self):
        return checkpoint_steps(self.directory)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> pathlib.Path:
        return self.directory / str(step)

    def save(self, step: int, state: dict, *, serving=None, force: bool = False) -> bool:
        """Write checkpoint ``step`` unless it exists or (without ``force``)
        ``step`` is not a multiple of the save interval, or this process is
        not rank 0 of a multi-process run. ``serving`` is ``(model_name,
        config, state_dict)`` for the serving checkpoint."""
        if not writes_files() or step in self.all_steps():
            return False
        if not force and step % self.save_interval_steps:
            return False
        tmp = self.directory / f".{step}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(state, tmp / STATE_FILE)
        if serving is not None:
            save_checkpoint(tmp, *serving)
        os.replace(tmp, self.path(step))
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self.path(old))
        return True

    def restore(self, step: Optional[int] = None) -> Any:
        """The state dict of checkpoint ``step`` (the newest by default), on
        the CPU."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return torch.load(self.path(step) / STATE_FILE, map_location="cpu", weights_only=False)
