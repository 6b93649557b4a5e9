"""Config persistence and the port's checkpoint format.

Counterpart of the config half of ``neuraltexttospeech_tpu/models/registry.py``
over the port's two config classes. A port checkpoint is a directory that
holds ``model.pt`` (a ``torch.save``d state dict) and ``model_config.json``
(``{"model": name, "config": {...}, "frontend": {...}}``, the same file the
JAX training CLIs write).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Dict

import torch

from .fastpitch import FastPitch, FastPitchConfig
from .hifigan import Generator, HiFiGANConfig

__all__ = ["CONFIG_REGISTRY", "MODEL_REGISTRY", "config_to_dict", "config_from_dict",
           "find_model_config", "load_model_config", "load_frontend_config",
           "save_model_config", "save_checkpoint", "load_checkpoint"]

MODEL_REGISTRY: Dict[str, type] = {"FastPitch": FastPitch, "HiFiGAN": Generator}
CONFIG_REGISTRY: Dict[str, type] = {"FastPitch": FastPitchConfig,
                                    "HiFiGAN": HiFiGANConfig}
WEIGHTS_FILE = "model.pt"


def config_to_dict(config) -> dict:
    """Dataclass config → JSON-able dict."""

    def conv(v):
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return {f.name: conv(getattr(v, f.name)) for f in dataclasses.fields(v)}
        if isinstance(v, (tuple, list)):
            return [conv(x) for x in v]
        return v

    return conv(config)


def _tuplify(v):
    if isinstance(v, list):
        return tuple(_tuplify(x) for x in v)
    return v


def config_from_dict(config_cls: type, data: dict):
    """Rebuild a config dataclass (lists → tuples). Keys the class does not
    have, such as the JAX configs' ``dtype`` or TPU-only switches, are
    ignored."""
    kw = {f.name: _tuplify(data[f.name]) for f in dataclasses.fields(config_cls)
          if f.name in data}
    return config_cls(**kw)


def find_model_config(path) -> pathlib.Path | None:
    """Locate ``model_config.json`` for a file, run dir, or checkpoint dir
    (checks the path, the dir itself, and its parent run dir)."""
    p = pathlib.Path(path)
    if p.is_file():
        return p
    for cand in (p / "model_config.json", p.parent / "model_config.json"):
        if cand.exists():
            return cand
    return None


def load_model_config(path):
    """Read (model_name, config) from ``model_config.json``."""
    found = find_model_config(path)
    if found is None:
        raise FileNotFoundError(f"no model_config.json near {path}")
    data = json.loads(found.read_text())
    return data["model"], config_from_dict(CONFIG_REGISTRY[data["model"]],
                                           data["config"])


def load_frontend_config(path, default=None):
    """Read the saved text front-end dict from a run's ``model_config.json``;
    returns ``default`` when the file or the key is absent."""
    found = find_model_config(path)
    if found is None:
        return default
    return json.loads(found.read_text()).get("frontend", default)


def save_model_config(output_dir, name: str, config, frontend=None) -> pathlib.Path:
    """Write ``model_config.json`` into ``output_dir`` (a run or checkpoint dir)."""
    p = pathlib.Path(output_dir)
    p.mkdir(parents=True, exist_ok=True)
    payload = {"model": name, "config": config_to_dict(config)}
    if frontend:
        payload["frontend"] = frontend
    (p / "model_config.json").write_text(json.dumps(payload, indent=1))
    return p


def save_checkpoint(output_dir, name: str, config, state_dict,
                    frontend=None) -> pathlib.Path:
    """Write ``model.pt`` and ``model_config.json`` into ``output_dir``."""
    p = save_model_config(output_dir, name, config, frontend)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, p / WEIGHTS_FILE)
    return p


def load_checkpoint(path, expected_model: str, device: torch.device, config=None):
    """Build the model of a port checkpoint on ``device``, in eval mode.
    ``path`` is the checkpoint dir or its ``model.pt``; ``config`` replaces
    the checkpoint's own (the weights must fit it). Returns (model, config)."""
    p = pathlib.Path(path)
    weights = p if p.is_file() else p / WEIGHTS_FILE
    name, saved = load_model_config(weights.parent)
    if name != expected_model:
        raise ValueError(f"{path} holds a {name} checkpoint, expected {expected_model}")
    config = config or saved
    model = MODEL_REGISTRY[name](config)
    model.load_state_dict(torch.load(weights, map_location="cpu", weights_only=True))
    return model.to(device).eval(), config
