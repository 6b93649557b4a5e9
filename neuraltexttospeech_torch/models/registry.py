"""Config persistence and the port's checkpoint format.

Counterpart of the config half of ``neuraltexttospeech_tpu/models/registry.py``
over the port's config classes, with its ``--override`` parser
(:func:`apply_overrides`). A port checkpoint is a directory that
holds ``model.pt`` (a ``torch.save``d state dict) and ``model_config.json``
(``{"model": name, "config": {...}, "frontend": {...}}``, the same file the
JAX training CLIs write). A config's ``dtype`` is a run-time choice (the
CLIs' ``--amp``) and is neither written nor read, as in the JAX registry.

``"QuartzNet"`` builds the ASR (29 outputs, JAX's ``get_model`` default);
``"TalkNet2"`` names the config that the three TalkNet 2 heads share, so
it has no model class: a head's checkpoint is loaded with its class
(``load_checkpoint(..., model_cls=)``).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Dict

import torch

from ..parallel.distributed import writes_files
from .diffwave import DiffWave, DiffWaveConfig
from .fastpitch import FastPitch, FastPitchConfig
from .fastspeech2 import FastSpeech2, FastSpeech2Config
from .flowtron import Flowtron, FlowtronConfig
from .gradtts import GradTTS, GradTTSConfig
from .hifigan import Generator, HiFiGANConfig
from .tacotron2 import Tacotron2, Tacotron2Config
from .talknet import QuartzNet, QuartzNetConfig, TalkNet2Config

__all__ = ["CONFIG_REGISTRY", "MODEL_REGISTRY", "config_to_dict", "config_from_dict",
           "find_model_config", "load_model_config", "load_frontend_config",
           "save_model_config", "save_checkpoint", "load_checkpoint", "apply_overrides"]

MODEL_REGISTRY: Dict[str, type] = {"FastPitch": FastPitch, "HiFiGAN": Generator,
                                   "DiffWave": DiffWave, "GradTTS": GradTTS,
                                   "FastSpeech2": FastSpeech2, "QuartzNet": QuartzNet,
                                   "Tacotron2": Tacotron2, "Flowtron": Flowtron}
CONFIG_REGISTRY: Dict[str, type] = {"FastPitch": FastPitchConfig, "HiFiGAN": HiFiGANConfig,
                                    "DiffWave": DiffWaveConfig, "GradTTS": GradTTSConfig,
                                    "FastSpeech2": FastSpeech2Config,
                                    "QuartzNet": QuartzNetConfig, "TalkNet2": TalkNet2Config,
                                    "Tacotron2": Tacotron2Config, "Flowtron": FlowtronConfig}
WEIGHTS_FILE = "model.pt"


def config_to_dict(config) -> dict:
    """Dataclass config → JSON-able dict (recursing into nested configs,
    without ``dtype``)."""

    def conv(v):
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return {f.name: conv(getattr(v, f.name)) for f in dataclasses.fields(v)
                    if f.name != "dtype"}
        if isinstance(v, (tuple, list)):
            return [conv(x) for x in v]
        return v

    return conv(config)


def _tuplify(v):
    if isinstance(v, list):
        return tuple(_tuplify(x) for x in v)
    return v


def config_from_dict(config_cls: type, data: dict):
    """Rebuild a config dataclass: lists → tuples, a nested config from its
    dict (by the type of the field's default). Keys the class does not
    have, such as TPU-only switches, and ``dtype`` are ignored."""
    kw = {}
    for f in dataclasses.fields(config_cls):
        if f.name == "dtype" or f.name not in data:
            continue
        default = f.default
        if dataclasses.is_dataclass(default) and not isinstance(default, type):
            kw[f.name] = config_from_dict(type(default), data[f.name])
        else:
            kw[f.name] = _tuplify(data[f.name])
    return config_cls(**kw)


def apply_overrides(config, overrides):
    """Apply ``["key=value", ...]`` onto a config dataclass; dotted keys reach
    nested configs (``backbone.module_repeat=1``). Values parse as JSON with
    a plain-string fallback; lists become tuples (JAX ``registry.py:91-111``)."""
    for item in overrides or []:
        key, _, raw = item.partition("=")
        try:
            value = _tuplify(json.loads(raw))
        except (ValueError, TypeError):
            value = raw
        config = _replace_path(config, key.strip().split("."), value)
    return config


def _replace_path(config, parts, value):
    if len(parts) == 1:
        return dataclasses.replace(config, **{parts[0]: value})
    child = _replace_path(getattr(config, parts[0]), parts[1:], value)
    return dataclasses.replace(config, **{parts[0]: child})


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
    """Write ``model_config.json`` into ``output_dir`` (a run or checkpoint
    dir); in a multi-process run only rank 0 writes."""
    p = pathlib.Path(output_dir)
    if not writes_files():
        return p
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


def load_checkpoint(path, expected_model: str, device: torch.device, config=None,
                    model_cls=None):
    """Build the model of a port checkpoint on ``device``, in eval mode.
    ``path`` is the checkpoint dir or its ``model.pt``; ``config`` replaces
    the checkpoint's own (the weights must fit it); ``model_cls`` replaces
    the registry's class (a TalkNet 2 head). Returns (model, config)."""
    p = pathlib.Path(path)
    weights = p if p.is_file() else p / WEIGHTS_FILE
    name, saved = load_model_config(weights.parent)
    if name != expected_model:
        raise ValueError(f"{path} holds a {name} checkpoint, expected {expected_model}")
    config = config or saved
    model = (model_cls or MODEL_REGISTRY[name])(config)
    model.load_state_dict(torch.load(weights, map_location="cpu", weights_only=True))
    return model.to(device).eval(), config
