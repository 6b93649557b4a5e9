"""Export a training checkpoint as a single-file inference artifact.

Port of ``tools/export.py``: the newest step of a port checkpoint dir (a
training run, its ``checkpoints`` dir, or one step) → the model's bare state
dict in one ``torch.save`` file, and ``{model, step, config}`` beside it
with the suffix ``.json``. The config is the checkpoint's own
(``model_config.json``), so the artifact rebuilds the model it came from
(:func:`load_export`); the JAX tool writes the registry's default config
for the name.

Usage:
  python -m neuraltexttospeech_torch.cli.export --model FastPitch \\
      --checkpoint out/fastpitch -o fastpitch.pt
"""

from __future__ import annotations

import argparse
import json
import pathlib

import torch

from ..models.registry import (CONFIG_REGISTRY, MODEL_REGISTRY, WEIGHTS_FILE, config_from_dict,
                               config_to_dict, load_model_config)
from ..train.checkpoint import checkpoint_dir


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", required=True, help="registry name (FastPitch, Flowtron, ...)")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("-o", "--output", required=True)
    return p.parse_args(argv)


def load_export(path, device="cpu"):
    """The model of an exported artifact (``path`` and its ``.json``) in
    eval mode on ``device``. Returns (model, meta)."""
    path = pathlib.Path(path)
    meta = json.loads(path.with_suffix(".json").read_text())
    config = config_from_dict(CONFIG_REGISTRY[meta["model"]], meta["config"])
    model = MODEL_REGISTRY[meta["model"]](config)
    model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    return model.to(device).eval(), meta


def main(argv=None):
    """Export; returns the artifact's ``.json`` contents."""
    args = parse_args(argv)
    ckpt = checkpoint_dir(args.checkpoint)
    name, config = load_model_config(ckpt)
    if name != args.model:
        raise SystemExit(f"{ckpt} holds a {name} checkpoint, not {args.model}")
    out = pathlib.Path(args.output)
    out.parent.mkdir(parents=True, exist_ok=True)
    state = torch.load(ckpt / WEIGHTS_FILE, map_location="cpu", weights_only=True)
    torch.save(state, out)
    meta = {"model": name, "step": int(ckpt.name) if ckpt.name.isdigit() else None,
            "config": config_to_dict(config)}
    out.with_suffix(".json").write_text(json.dumps(meta, indent=2))
    print(f"exported {name} step {meta['step']} → {out} ({out.stat().st_size / 1e6:.1f} MB)")
    return meta


if __name__ == "__main__":
    main()
