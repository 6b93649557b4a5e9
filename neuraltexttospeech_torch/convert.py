"""Carry flax parameter trees over to the port's PyTorch state dicts.

The input is the flax ``params`` tree (or ``{"params": tree}``) as nested
dicts of numpy arrays, as ``flax.serialization`` or an orbax restore gives it
once converted with ``np.asarray``; nothing here imports flax. Mappings:

- Dense ``kernel [in, out]`` → ``Linear.weight [out, in]``. The fused QKV
  output features stay in JAX's ``[3][heads][d_head]`` order.
- Conv ``kernel [K, Cin, Cout]`` → ``Conv1d.weight [Cout, Cin, K]``.
- ``ConvTranspose(transpose_kernel=True)`` ``kernel [K, out, in]`` →
  ``ConvTranspose1d.weight [in, out, K]`` (a transpose, no spatial flip;
  the padding lives in ``models/hifigan.py::transpose_padding``).
- LayerNorm ``scale``/``bias`` → ``weight``/``bias`` (the eps of 1e-3 is
  the module's).
- Embed ``embedding`` → ``Embedding.weight``.
- ``nn.WeightNorm``: flax keeps the wrapped layer's ``kernel`` as ``v`` and a
  sibling ``WeightNorm_i`` dict with ``"<layer>/kernel/scale"``. It is folded
  at load into ``w = v · rsqrt(Σ v² + 1e-12) · scale``, the sum over every
  axis but the last (Cout for a conv, in-features for the transposed conv).

Every leaf must be consumed, or the conversion raises. The one exception is
FastPitch's ``attention`` subtree (the ``ConvAttention`` aligner), which only
the training forward uses: it is skipped by name.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch

__all__ = ["fastpitch_from_flax", "generator_from_flax", "fold_weight_norm"]

_WN_EPS = 1e-12


def _params(tree) -> dict:
    if set(tree) == {"params"}:
        tree = tree["params"]
    return tree


def fold_weight_norm(tree: Mapping) -> dict:
    """A copy of ``tree`` with every ``WeightNorm_i`` scale folded into the
    kernel of the layer it wraps, and the ``WeightNorm_i`` dicts removed."""
    out = {k: (fold_weight_norm(v) if isinstance(v, Mapping) else np.asarray(v))
           for k, v in tree.items() if not k.startswith("WeightNorm_")}
    for key, wn in tree.items():
        if not key.startswith("WeightNorm_"):
            continue
        for path, scale in wn.items():
            *layer, leaf, kind = path.split("/")
            if kind != "scale" or leaf != "kernel":
                raise ValueError(f"unsupported weight-norm leaf {key}/{path}")
            node = out
            for name in layer:
                node = node[name]
            v = np.asarray(node["kernel"], np.float32)
            axes = tuple(range(v.ndim - 1))
            norm = 1.0 / np.sqrt(np.sum(v * v, axis=axes, keepdims=True) + _WN_EPS)
            node["kernel"] = v * norm * np.asarray(scale, np.float32)
    return out


class _Reader:
    """Pops leaves from a nested dict; :meth:`finish` raises on any left."""

    def __init__(self, tree: dict):
        self.tree = tree

    def node(self, *path) -> dict:
        node = self.tree
        for name in path:
            if name not in node:
                raise KeyError(f"missing parameter group {'/'.join(path)}")
            node = node[name]
        return node

    def pop(self, *path) -> np.ndarray:
        parent = self.node(*path[:-1])
        if path[-1] not in parent:
            raise KeyError(f"missing parameter {'/'.join(path)}")
        return np.asarray(parent.pop(path[-1]), np.float32)

    def count(self, *path, prefix: str) -> int:
        pat = re.compile(re.escape(prefix) + r"_(\d+)$")
        return sum(1 for k in self.node(*path) if pat.match(k))

    def finish(self):
        left = []

        def walk(node, pre):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, pre + k + "/")
                else:
                    left.append(pre + k)

        walk(self.tree, "")
        if left:
            raise ValueError(f"unconsumed parameters: {left}")


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _dense(sd, key, r: _Reader, *path):
    sd[f"{key}.weight"] = _t(r.pop(*path, "kernel").T)
    if "bias" in r.node(*path):
        sd[f"{key}.bias"] = _t(r.pop(*path, "bias"))


def _conv(sd, key, r: _Reader, *path):
    sd[f"{key}.weight"] = _t(r.pop(*path, "kernel").transpose(2, 1, 0))
    if "bias" in r.node(*path):
        sd[f"{key}.bias"] = _t(r.pop(*path, "bias"))


def _layer_norm(sd, key, r: _Reader, *path):
    sd[f"{key}.weight"] = _t(r.pop(*path, "scale"))
    sd[f"{key}.bias"] = _t(r.pop(*path, "bias"))


def _fft(sd, key, r: _Reader, name: str):
    for i in range(r.count(name, prefix="blocks")):
        blk = (name, f"blocks_{i}")
        attn, ff = f"{key}.layers.{i}.attn", f"{key}.layers.{i}.ff"
        _dense(sd, f"{attn}.qkv", r, *blk, "MultiHeadAttn_0", "Dense_0")
        _dense(sd, f"{attn}.o", r, *blk, "MultiHeadAttn_0", "Dense_1")
        _layer_norm(sd, f"{attn}.layer_norm", r, *blk, "MultiHeadAttn_0", "LayerNorm_0")
        _conv(sd, f"{ff}.conv1", r, *blk, "PositionwiseConvFF_0", "Conv_0")
        _conv(sd, f"{ff}.conv2", r, *blk, "PositionwiseConvFF_0", "Conv_1")
        _layer_norm(sd, f"{ff}.layer_norm", r, *blk, "PositionwiseConvFF_0", "LayerNorm_0")


def _predictor(sd, key, r: _Reader):
    for i in range(r.count(key, prefix="ConvReLUNorm")):
        _conv(sd, f"{key}.layers.{i}.conv", r, key, f"ConvReLUNorm_{i}", "Conv_0")
        _layer_norm(sd, f"{key}.layers.{i}.norm", r, key, f"ConvReLUNorm_{i}", "LayerNorm_0")
    _dense(sd, f"{key}.fc", r, key, "Dense_0")


def fastpitch_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """flax ``FastPitch`` params → ``models.fastpitch.FastPitch`` state dict.
    Skips the ``attention`` (aligner) subtree; raises on any other leaf it
    does not consume."""
    tree = fold_weight_norm(_params(params))
    tree.pop("attention", None)
    r = _Reader(tree)
    sd: Dict[str, torch.Tensor] = {}
    sd["encoder.word_emb.weight"] = _t(r.pop("encoder", "word_emb", "embedding"))
    _fft(sd, "encoder", r, "encoder")
    _fft(sd, "decoder", r, "decoder")
    for name in ("duration_predictor", "pitch_predictor", "energy_predictor"):
        if name in tree:
            _predictor(sd, name, r)
    _conv(sd, "pitch_emb", r, "pitch_emb")
    if "energy_emb" in tree:
        _conv(sd, "energy_emb", r, "energy_emb")
    if "speaker_emb" in tree:
        sd["speaker_emb.weight"] = _t(r.pop("speaker_emb", "embedding"))
    _dense(sd, "proj", r, "proj")
    r.finish()
    return sd


def generator_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """flax HiFi-GAN ``Generator`` params → ``models.hifigan.Generator``
    state dict, weight norm folded. Raises on any leaf it does not consume."""
    r = _Reader(fold_weight_norm(_params(params)))
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "conv_pre", r, "Conv_0")
    n_ups = r.count(prefix="ConvTranspose")
    for i in range(n_ups):
        _conv(sd, f"ups.{i}", r, f"ConvTranspose_{i}")  # [K, out, in] -> [in, out, K]
    kind = "ResBlock1" if r.count(prefix="ResBlock1") else "ResBlock2"
    for i in range(r.count(prefix=kind)):
        n_convs = r.count(f"{kind}_{i}", prefix="Conv")
        if kind == "ResBlock1":
            for d in range(n_convs // 2):
                _conv(sd, f"resblocks.{i}.convs1.{d}", r, f"{kind}_{i}", f"Conv_{2 * d}")
                _conv(sd, f"resblocks.{i}.convs2.{d}", r, f"{kind}_{i}", f"Conv_{2 * d + 1}")
        else:
            for d in range(n_convs):
                _conv(sd, f"resblocks.{i}.convs.{d}", r, f"{kind}_{i}", f"Conv_{d}")
    _conv(sd, "conv_post", r, "Conv_1")
    r.finish()
    return sd
