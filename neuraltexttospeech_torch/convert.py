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

For training (:func:`hifigan_train_from_flax`) weight norm is kept: the
kernel becomes the parametrization's ``original0`` (``v``, in the torch
layout) and the scale its ``original1`` (``nn/norms.py``); the MSD's
spectral-norm stats ``u`` and ``sigma`` become the ``sn.<i>`` buffers.

Every leaf must be consumed, or the conversion raises. The one exception is
FastPitch's ``attention`` subtree (the ``ConvAttention`` aligner) in
:func:`fastpitch_from_flax`, the serving conversion, which skips it by name;
:func:`fastpitch_train_from_flax` carries it too.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch

__all__ = ["fastpitch_from_flax", "fastpitch_train_from_flax", "generator_from_flax",
           "fold_weight_norm", "hifigan_train_from_flax"]

_WN_EPS = 1e-12
_WN = ".parametrizations.weight."


def _plain(tree):
    """A copy of nested mappings as nested dicts (the reader pops from it)."""
    if isinstance(tree, Mapping):
        return {k: _plain(v) for k, v in tree.items()}
    return tree


def _params(tree) -> dict:
    if set(tree) == {"params"}:
        tree = tree["params"]
    return tree


def split_weight_norm(tree: Mapping) -> dict:
    """A copy of ``tree`` where each ``WeightNorm_i`` scale sits beside the
    kernel of the layer it wraps, as ``wn_scale``."""
    out = {k: (split_weight_norm(v) if isinstance(v, Mapping) else np.asarray(v))
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
            node["wn_scale"] = np.asarray(scale, np.float32)
    return out


def fold_weight_norm(tree: Mapping) -> dict:
    """A copy of ``tree`` with every ``WeightNorm_i`` scale folded into the
    kernel of the layer it wraps, and the ``WeightNorm_i`` dicts removed."""
    return _fold_scales(split_weight_norm(tree))


def _fold_scales(node: dict) -> dict:
    out = {k: (_fold_scales(v) if isinstance(v, dict) else v)
           for k, v in node.items() if k != "wn_scale"}
    if "wn_scale" in node:
        v = np.asarray(out["kernel"], np.float32)
        axes = tuple(range(v.ndim - 1))
        norm = 1.0 / np.sqrt(np.sum(v * v, axis=axes, keepdims=True) + _WN_EPS)
        out["kernel"] = v * norm * node["wn_scale"]
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


# flax ConvAttention's convs in creation order -> the port's module names
_ALIGNER_CONVS = ("key_conv1", "key_conv2", "query_conv1", "query_conv2", "query_conv3")


def fastpitch_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """flax ``FastPitch`` params → ``models.fastpitch.FastPitch`` serving
    state dict. Skips the ``attention`` (aligner) subtree; raises on any
    other leaf it does not consume."""
    tree = fold_weight_norm(_params(params))
    tree.pop("attention", None)
    return _fastpitch(tree)


def fastpitch_train_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """flax ``FastPitch`` params, the aligner included → the full
    ``models.fastpitch.FastPitch`` state dict that the training forward
    needs. Raises on any leaf it does not consume."""
    return _fastpitch(fold_weight_norm(_params(params)), aligner=True)


def _fastpitch(tree: dict, aligner: bool = False) -> Dict[str, torch.Tensor]:
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
    if aligner:
        for i, name in enumerate(_ALIGNER_CONVS):
            _conv(sd, f"attention.{name}", r, "attention", f"Conv_{i}")
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


def _wn_conv(sd, key, r: _Reader, *path, kernel=lambda k: k.transpose(2, 1, 0)):
    """A weight-normed conv: kernel → ``v`` (``kernel`` maps it to the torch
    layout), scale, bias."""
    sd[f"{key}{_WN}original0"] = _t(kernel(r.pop(*path, "kernel")))
    sd[f"{key}{_WN}original1"] = _t(r.pop(*path, "wn_scale"))
    sd[f"{key}.bias"] = _t(r.pop(*path, "bias"))


def _generator_train(r: _Reader) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    _wn_conv(sd, "conv_pre", r, "Conv_0")
    for i in range(r.count(prefix="ConvTranspose")):
        _wn_conv(sd, f"ups.{i}", r, f"ConvTranspose_{i}")
    kind = "ResBlock1" if r.count(prefix="ResBlock1") else "ResBlock2"
    for i in range(r.count(prefix=kind)):
        n_convs = r.count(f"{kind}_{i}", prefix="Conv")
        if kind == "ResBlock1":
            for d in range(n_convs // 2):
                _wn_conv(sd, f"resblocks.{i}.convs1.{d}", r, f"{kind}_{i}", f"Conv_{2 * d}")
                _wn_conv(sd, f"resblocks.{i}.convs2.{d}", r, f"{kind}_{i}", f"Conv_{2 * d + 1}")
        else:
            for d in range(n_convs):
                _wn_conv(sd, f"resblocks.{i}.convs.{d}", r, f"{kind}_{i}", f"Conv_{d}")
    _wn_conv(sd, "conv_post", r, "Conv_1")
    return sd


def hifigan_train_from_flax(gen: dict, mpd: dict, msd: dict, msd_stats: dict):
    """flax HiFi-GAN train params → state dicts of the port's training
    modules, weight norm kept: ``(Generator(weight_norm=True),
    MultiPeriodDiscriminator, MultiScaleDiscriminator)``. ``msd_stats`` is the
    ``batch_stats`` tree of the MSD's spectral norm. Raises on any leaf it
    does not consume."""
    rg = _Reader(split_weight_norm(_params(gen)))
    gen_sd = _generator_train(rg)
    rg.finish()

    rp = _Reader(split_weight_norm(_params(mpd)))
    mpd_sd: Dict[str, torch.Tensor] = {}
    for i in range(rp.count(prefix="DiscriminatorP")):
        n = rp.count(f"DiscriminatorP_{i}", prefix="Conv")
        for j in range(n):  # kernel [5, 1, Cin, Cout] -> [Cout, Cin, 5]
            key = (f"discriminators.{i}.convs.{j}" if j < n - 1
                   else f"discriminators.{i}.conv_post")
            _wn_conv(mpd_sd, key, rp, f"DiscriminatorP_{i}", f"Conv_{j}",
                     kernel=lambda k: k[:, 0].transpose(2, 1, 0))
    rp.finish()

    rs = _Reader(split_weight_norm(_params(msd)))
    stats = _Reader(_plain(msd_stats.get("batch_stats", msd_stats)))
    msd_sd: Dict[str, torch.Tensor] = {}
    for i in range(rs.count(prefix="DiscriminatorS")):
        name = f"DiscriminatorS_{i}"
        n = rs.count(name, prefix="Conv")
        for j in range(n):
            key = f"discriminators.{i}." + (f"convs.{j}" if j < n - 1 else "conv_post")
            if "wn_scale" in rs.node(name, f"Conv_{j}"):
                _wn_conv(msd_sd, key, rs, name, f"Conv_{j}")
                continue
            _conv(msd_sd, key, rs, name, f"Conv_{j}")
            sn = next(k for k in stats.node(name) if f"Conv_{j}/kernel/u" in stats.node(name, k))
            msd_sd[f"discriminators.{i}.sn.{j}.u"] = _t(stats.pop(name, sn, f"Conv_{j}/kernel/u"))
            msd_sd[f"discriminators.{i}.sn.{j}.sigma"] = _t(
                stats.pop(name, sn, f"Conv_{j}/kernel/sigma"))
    rs.finish()
    stats.finish()
    return gen_sd, mpd_sd, msd_sd
