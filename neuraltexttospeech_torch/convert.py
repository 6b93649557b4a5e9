"""Carry flax parameter trees over to the port's PyTorch state dicts.

The input is the flax ``params`` tree (or ``{"params": tree}``) as nested
dicts of numpy arrays, as ``flax.serialization`` or an orbax restore gives it
once converted with ``np.asarray``; nothing here imports flax. Mappings:

- Dense ``kernel [in, out]`` → ``Linear.weight [out, in]``. The fused QKV
  output features stay in JAX's ``[3][heads][d_head]`` order.
- Conv ``kernel [K, Cin, Cout]`` → ``Conv1d.weight [Cout, Cin, K]``.
- ``ConvTranspose(transpose_kernel=True)`` ``kernel [K, out, in]`` →
  ``ConvTranspose1d.weight [in, out, K]`` (a transpose, no spatial flip;
  the padding lives in ``models/hifigan.py::transpose_padding``); in 2-D
  ``kernel [Kh, Kw, out, in]`` → ``ConvTranspose2d.weight [in, out, Kh, Kw]``.
- 2-D Conv ``kernel [Kh, Kw, Cin, Cout]`` → ``Conv2d.weight [Cout, Cin, Kh, Kw]``.
- GroupNorm ``scale``/``bias`` → ``weight``/``bias``.
- LayerNorm ``scale``/``bias`` → ``weight``/``bias`` (the eps of 1e-3 is
  the module's).
- Embed ``embedding`` → ``Embedding.weight``.
- LSTM cells (``LSTMCell``/``OptimizedLSTMCell``): the input kernels
  ``ii/if/ig/io [in, H]`` → ``weight_ih [4H, in]`` and the hidden kernels
  ``hi/hf/hg/ho [H, H]`` → ``weight_hh [4H, H]``, stacked in gate order, their
  biases → ``bias_hh [4H]`` (``nn/rnn.py::LSTMCell``).
- Flowtron's ``MaskedInstanceNorm`` ``scale``/``bias`` → its affine
  ``weight``/``bias`` (parameters, not BatchNorm statistics).
- BatchNorm ``scale``/``bias`` → ``weight``/``bias``, and its
  ``batch_stats`` ``mean``/``var`` → the ``running_mean``/``running_var``
  buffers (``nn/layers.py::BatchNorm``). A depthwise conv's kernel ``[K, 1,
  C]`` → ``[C, 1, K]`` like any conv's.
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
           "fold_weight_norm", "hifigan_train_from_flax", "diffwave_from_flax",
           "gradtts_from_flax", "fastspeech2_from_flax", "quartznet_from_flax",
           "talknet_from_flax", "tacotron2_from_flax", "flowtron_from_flax"]

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


def _conv2d(sd, key, r: _Reader, *path):
    sd[f"{key}.weight"] = _t(r.pop(*path, "kernel").transpose(3, 2, 0, 1))
    if "bias" in r.node(*path):
        sd[f"{key}.bias"] = _t(r.pop(*path, "bias"))


def diffwave_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """flax ``DiffWave`` params → ``models.diffwave.DiffWave`` state dict
    (conditional or unconditional, read from the tree). Raises on any leaf
    it does not consume."""
    tree = _params(_plain(params))
    r = _Reader(tree)
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "input_projection", r, "Conv_0")
    _dense(sd, "diffusion_embedding.projection1", r, "DiffusionEmbedding_0", "Dense_0")
    _dense(sd, "diffusion_embedding.projection2", r, "DiffusionEmbedding_0", "Dense_1")
    if "SpectrogramUpsampler_0" in tree:
        for i in range(2):  # kernel [32, 3, out, in] -> [in, out, 32, 3]
            _conv2d(sd, f"spectrogram_upsampler.conv{i + 1}", r, "SpectrogramUpsampler_0",
                    f"ConvTranspose_{i}")
    for i in range(r.count(prefix="ResidualBlock")):
        blk, key = f"ResidualBlock_{i}", f"residual_layers.{i}"
        conditional = r.count(blk, prefix="Conv") == 3
        _dense(sd, f"{key}.diffusion_projection", r, blk, "Dense_0")
        _conv(sd, f"{key}.dilated_conv", r, blk, "Conv_0")
        if conditional:
            _conv(sd, f"{key}.conditioner_projection", r, blk, "Conv_1")
        _conv(sd, f"{key}.output_projection", r, blk, f"Conv_{2 if conditional else 1}")
    _conv(sd, "skip_projection", r, "Conv_1")
    _conv(sd, "output_projection", r, "Conv_2")
    r.finish()
    return sd


def _gradtts_encoder(sd, r: _Reader):
    enc = ("encoder",)
    sd["encoder.emb.weight"] = _t(r.pop(*enc, "Embed_0", "embedding"))
    for i in range(3):
        _conv(sd, f"encoder.prenet.convs.{i}", r, *enc, "ConvReluNormPrenet_0", f"Conv_{i}")
        _layer_norm(sd, f"encoder.prenet.norms.{i}", r, *enc, "ConvReluNormPrenet_0",
                    f"LayerNorm_{i}")
    _conv(sd, "encoder.prenet.proj", r, *enc, "ConvReluNormPrenet_0", "Conv_3")
    n_layers = r.count(*enc, prefix="RelPositionMultiHeadAttention")
    convs = 0
    if r.count(*enc, prefix="Conv") == 2:  # the speaker projection comes first
        _conv(sd, "encoder.spk_proj", r, *enc, "Conv_0")
        convs = 1
    for i in range(n_layers):
        attn, key = (*enc, f"RelPositionMultiHeadAttention_{i}"), f"encoder.attn_layers.{i}"
        for j, name in enumerate(("conv_q", "conv_k", "conv_v", "conv_o")):
            _conv(sd, f"{key}.{name}", r, *attn, f"Conv_{j}")
        sd[f"{key}.emb_rel_k"] = _t(r.pop(*attn, "emb_rel_k"))
        sd[f"{key}.emb_rel_v"] = _t(r.pop(*attn, "emb_rel_v"))
        _layer_norm(sd, f"encoder.norms1.{i}", r, *enc, f"LayerNorm_{2 * i}")
        _conv(sd, f"encoder.ffn_layers.{i}.conv1", r, *enc, f"EncFFN_{i}", "Conv_0")
        _conv(sd, f"encoder.ffn_layers.{i}.conv2", r, *enc, f"EncFFN_{i}", "Conv_1")
        _layer_norm(sd, f"encoder.norms2.{i}", r, *enc, f"LayerNorm_{2 * i + 1}")
    _conv(sd, "encoder.proj_m", r, *enc, f"Conv_{convs}")
    dp = (*enc, "DurationPredictor_0")
    for i in range(2):
        _conv(sd, f"encoder.proj_w.convs.{i}", r, *dp, f"Conv_{i}")
        _layer_norm(sd, f"encoder.proj_w.norms.{i}", r, *dp, f"LayerNorm_{i}")
    _conv(sd, "encoder.proj_w.proj", r, *dp, "Conv_2")


def _unet_block(sd, key, r: _Reader, *path):
    _conv2d(sd, f"{key}.conv", r, *path, "Conv_0")
    _layer_norm(sd, f"{key}.norm", r, *path, "GroupNorm_0")


def _unet_resnet(sd, key, r: _Reader, *path):
    _unet_block(sd, f"{key}.block1", r, *path, "UNetBlock_0")
    _dense(sd, f"{key}.mlp", r, *path, "Dense_0")
    _unet_block(sd, f"{key}.block2", r, *path, "UNetBlock_1")
    if "Conv_0" in r.node(*path):
        _conv2d(sd, f"{key}.res_conv", r, *path, "Conv_0")


def _rezero(sd, key, r: _Reader, *path):
    sd[f"{key}.g"] = _t(r.pop(*path, "g"))
    _conv2d(sd, f"{key}.attn.to_qkv", r, *path, "LinearAttention2D_0", "Conv_0")
    _conv2d(sd, f"{key}.attn.to_out", r, *path, "LinearAttention2D_0", "Conv_1")


def gradtts_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """flax ``GradTTS`` params → ``models.gradtts.GradTTS`` state dict (the
    speaker table and projections when the tree has them). The trees that
    ``GradTTS.compute_loss`` and synthesis initialise are the same (dropout
    holds no parameters), so this serves training too. Raises on any leaf it
    does not consume."""
    tree = _params(_plain(params))
    r = _Reader(tree)
    sd: Dict[str, torch.Tensor] = {}
    if "spk_emb" in tree:
        sd["spk_emb.weight"] = _t(r.pop("spk_emb", "embedding"))
    _gradtts_encoder(sd, r)
    est, key = ("decoder", "estimator"), "decoder.estimator"
    _dense(sd, f"{key}.time_mlp1", r, *est, "Dense_0")
    _dense(sd, f"{key}.time_mlp2", r, *est, "Dense_1")
    if r.count(*est, prefix="Dense") == 4:
        _dense(sd, f"{key}.spk_mlp.0", r, *est, "Dense_2")
        _dense(sd, f"{key}.spk_mlp.1", r, *est, "Dense_3")
    n_levels = r.count(*est, prefix="ConvTranspose") + 1
    res = att = 0
    for i in range(n_levels):
        _unet_resnet(sd, f"{key}.downs.{i}.0", r, *est, f"UNetResnetBlock_{res}")
        _unet_resnet(sd, f"{key}.downs.{i}.1", r, *est, f"UNetResnetBlock_{res + 1}")
        _rezero(sd, f"{key}.downs.{i}.2", r, *est, f"ReZeroAttention_{att}")
        res, att = res + 2, att + 1
        if i < n_levels - 1:
            _conv2d(sd, f"{key}.downs.{i}.3", r, *est, f"Conv_{i}")
    _unet_resnet(sd, f"{key}.mid.0", r, *est, f"UNetResnetBlock_{res}")
    _rezero(sd, f"{key}.mid.1", r, *est, f"ReZeroAttention_{att}")
    _unet_resnet(sd, f"{key}.mid.2", r, *est, f"UNetResnetBlock_{res + 1}")
    res, att = res + 2, att + 1
    for i in range(n_levels - 1):
        _unet_resnet(sd, f"{key}.ups.{i}.0", r, *est, f"UNetResnetBlock_{res}")
        _unet_resnet(sd, f"{key}.ups.{i}.1", r, *est, f"UNetResnetBlock_{res + 1}")
        _rezero(sd, f"{key}.ups.{i}.2", r, *est, f"ReZeroAttention_{att}")
        _conv2d(sd, f"{key}.ups.{i}.3", r, *est, f"ConvTranspose_{i}")  # [4, 4, out, in]
        res, att = res + 2, att + 1
    _unet_block(sd, f"{key}.final_block", r, *est, "UNetBlock_0")
    _conv2d(sd, f"{key}.final_conv", r, *est, f"Conv_{n_levels - 1}")
    r.finish()
    return sd


def fastspeech2_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """flax ``FastSpeech2`` params → ``models.fastspeech2.FastSpeech2`` state
    dict (the postnet when the tree has one). Raises on any leaf it does not
    consume."""
    tree = _params(_plain(params))
    r = _Reader(tree)
    sd: Dict[str, torch.Tensor] = {}
    sd["encoder.word_emb.weight"] = _t(r.pop("encoder", "word_emb", "embedding"))
    _fft(sd, "encoder", r, "encoder")
    _fft(sd, "decoder", r, "decoder")
    for name in ("duration_predictor", "pitch_predictor", "energy_predictor"):
        _predictor(sd, name, r)
    for name in ("pitch_embedding", "energy_embedding"):
        sd[f"{name}.weight"] = _t(r.pop(name, "embedding"))
    _dense(sd, "mel_linear", r, "mel_linear")
    if "postnet_net" in tree:
        for i in range(r.count("postnet_net", prefix="Conv")):
            _conv(sd, f"postnet.convs.{i}", r, "postnet_net", f"Conv_{i}")
            _layer_norm(sd, f"postnet.norms.{i}", r, "postnet_net", f"LayerNorm_{i}")
    r.finish()
    return sd


def _batch_norm(sd, key, r: _Reader, stats: _Reader, *path):
    """The flax ``BatchNorm`` at ``path``: parameters and statistics."""
    sd[f"{key}.weight"] = _t(r.pop(*path, "scale"))
    sd[f"{key}.bias"] = _t(r.pop(*path, "bias"))
    sd[f"{key}.running_mean"] = _t(stats.pop(*path, "mean"))
    sd[f"{key}.running_var"] = _t(stats.pop(*path, "var"))


def _sep_conv(sd, key, r: _Reader, path, first: int):
    _conv(sd, f"{key}.depthwise", r, *path, f"Conv_{first}")
    _conv(sd, f"{key}.pointwise", r, *path, f"Conv_{first + 1}")


def _quartznet(sd, prefix: str, r: _Reader, stats: _Reader, *path):
    """flax ``QuartzNet`` at ``path`` → ``models.talknet.QuartzNet`` keys
    under ``prefix``: its convs are ``Conv_0..5`` (initial depthwise and
    pointwise, penultimate depthwise and pointwise, final, output) and its
    BatchNorms ``_BN_0..2``; a block's are ``Conv_0`` and ``_BN_0`` (the
    residual), then ``Conv_{2i+1}``, ``Conv_{2i+2}`` and ``_BN_{i+1}``."""
    _sep_conv(sd, f"{prefix}initial", r, path, 0)
    _batch_norm(sd, f"{prefix}initial_bn", r, stats, *path, "_BN_0", "BatchNorm_0")
    for j in range(r.count(*path, prefix="QuartzNetBlock")):
        blk, bkey = (*path, f"QuartzNetBlock_{j}"), f"{prefix}blocks.{j}"
        _conv(sd, f"{bkey}.res_conv", r, *blk, "Conv_0")
        _batch_norm(sd, f"{bkey}.res_bn", r, stats, *blk, "_BN_0", "BatchNorm_0")
        for i in range(r.count(*blk, prefix="_BN") - 1):
            _sep_conv(sd, f"{bkey}.convs.{i}", r, blk, 2 * i + 1)
            _batch_norm(sd, f"{bkey}.bns.{i}", r, stats, *blk, f"_BN_{i + 1}",
                        "BatchNorm_0")
    _sep_conv(sd, f"{prefix}penultimate", r, path, 2)
    _batch_norm(sd, f"{prefix}penultimate_bn", r, stats, *path, "_BN_1", "BatchNorm_0")
    _conv(sd, f"{prefix}final_conv", r, *path, "Conv_4")
    _batch_norm(sd, f"{prefix}final_bn", r, stats, *path, "_BN_2", "BatchNorm_0")
    _conv(sd, f"{prefix}out", r, *path, "Conv_5")


def _readers(variables):
    tree = _plain(variables)
    return _Reader(tree["params"]), _Reader(tree["batch_stats"])


def quartznet_from_flax(variables: dict) -> Dict[str, torch.Tensor]:
    """flax ``QuartzNet`` variables ``{"params", "batch_stats"}`` →
    ``models.talknet.QuartzNet`` state dict (BatchNorm buffers included).
    Raises on any leaf of either tree it does not consume."""
    r, stats = _readers(variables)
    sd: Dict[str, torch.Tensor] = {}
    _quartznet(sd, "", r, stats)
    r.finish()
    stats.finish()
    return sd


def talknet_from_flax(variables: dict) -> Dict[str, torch.Tensor]:
    """flax TalkNet 2 head variables ``{"params", "batch_stats"}`` (a
    ``GraphemeDuration``, ``PitchPredictor`` or ``SpectrogramModel``, told
    apart by their trees) → the port head's state dict. Raises on any leaf
    of either tree it does not consume."""
    r, stats = _readers(variables)
    sd: Dict[str, torch.Tensor] = {}
    if "Embed_0" in r.tree:  # GraphemeDuration
        sd["embed.weight"] = _t(r.pop("Embed_0", "embedding"))
    else:  # PitchPredictor, SpectrogramModel
        sd["embed.embed.weight"] = _t(r.pop("GaussianEmbedding_0", "Embed_0", "embedding"))
        if "Conv_0" in r.tree:  # SpectrogramModel's pitch conv
            _conv(sd, "pitch_conv", r, "Conv_0")
    _quartznet(sd, "backbone.", r, stats, "QuartzNet_0")
    r.finish()
    stats.finish()
    return sd


def _lstm(sd, key, r: _Reader, *path):
    gates = "ifgo"
    sd[f"{key}.weight_ih"] = _t(np.concatenate([r.pop(*path, f"i{g}", "kernel")
                                                for g in gates], 1).T)
    sd[f"{key}.weight_hh"] = _t(np.concatenate([r.pop(*path, f"h{g}", "kernel")
                                                for g in gates], 1).T)
    sd[f"{key}.bias_hh"] = _t(np.concatenate([r.pop(*path, f"h{g}", "bias") for g in gates]))


def _bilstm(sd, key, r: _Reader, *path):
    """flax's pair of ``OptimizedLSTMCell``s (forward ``_0``, backward ``_1``)
    → ``nn/rnn.py::BiLSTM`` under ``key``."""
    _lstm(sd, f"{key}.fwd", r, *path, "OptimizedLSTMCell_0")
    _lstm(sd, f"{key}.bwd", r, *path, "OptimizedLSTMCell_1")


def tacotron2_from_flax(variables: dict) -> Dict[str, torch.Tensor]:
    """flax ``Tacotron2`` variables ``{"params", "batch_stats"}`` →
    ``models.tacotron2.Tacotron2`` state dict (BatchNorm buffers and the LSTM
    kernels included; the encoder's forward direction is
    ``OptimizedLSTMCell_0``, its backward ``_1``). Raises on any leaf of
    either tree it does not consume."""
    r, stats = _readers(variables)
    sd: Dict[str, torch.Tensor] = {"embedding.weight": _t(r.pop("embedding", "embedding"))}
    for part, node in (("encoder", "encoder"), ("postnet", "postnet")):
        for i in range(r.count(node, prefix="Conv")):
            _conv(sd, f"{part}.convs.{i}", r, node, f"Conv_{i}")
            _batch_norm(sd, f"{part}.norms.{i}", r, stats, node, f"BatchNorm_{i}")
    _bilstm(sd, "encoder.lstm", r, "encoder")
    for i in range(2):
        _dense(sd, f"cell.prenet.layers.{i}", r, "cell", "prenet", f"Dense_{i}")
    for name in ("attention_rnn", "decoder_rnn"):
        _lstm(sd, f"cell.{name}", r, "cell", name)
    attn = ("cell", "attention_layer")
    for name in ("query_layer", "memory_layer", "v"):
        _dense(sd, f"cell.attention_layer.{name}", r, *attn, name)
    _conv(sd, "cell.attention_layer.location_layer.conv", r, *attn, "location_layer", "Conv_0")
    _dense(sd, "cell.attention_layer.location_layer.dense", r, *attn, "location_layer",
           "Dense_0")
    _dense(sd, "cell.linear_projection", r, "cell", "linear_projection")
    _dense(sd, "cell.gate_layer", r, "cell", "gate_layer")
    r.finish()
    stats.finish()
    return sd


def _conv_norms(sd, key, r: _Reader, node: str):
    for i in range(r.count(node, prefix="Conv")):
        _conv(sd, f"{key}.convs.{i}", r, node, f"Conv_{i}")
        _layer_norm(sd, f"{key}.norms.{i}", r, node, f"MaskedInstanceNorm_{i}")


def flowtron_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """flax ``Flowtron`` params → ``models.flowtron.Flowtron`` state dict
    (the mel encoder and mixture head when the tree has them). Raises on
    any leaf it does not consume."""
    r = _Reader(_plain(_params(params)))
    sd: Dict[str, torch.Tensor] = {
        "speaker_embedding.weight": _t(r.pop("speaker_embedding", "embedding")),
        "encoder.embed.weight": _t(r.pop("encoder", "Embed_0", "embedding"))}
    _conv_norms(sd, "encoder", r, "encoder")
    _bilstm(sd, "encoder.lstm", r, "encoder")
    k = 0
    while f"flows_{k}" in r.tree:
        flow, key = f"flows_{k}", f"flows.{k}"
        _lstm(sd, f"{key}.attention_cell", r, flow, "attention_cell")
        for name in ("query_layer", "key_layer", "value_layer", "v"):
            _dense(sd, f"{key}.attention_layer.{name}", r, flow, "attention_layer", name)
        for i in range(r.count(flow, prefix="decoder_cells")):
            _lstm(sd, f"{key}.decoder_cells.{i}", r, flow, f"decoder_cells_{i}")
        for name in ("dense1", "dense2", "affine_out", "gate_layer"):
            if name in r.node(flow):
                _dense(sd, f"{key}.{name}", r, flow, name)
        k += 1
    if "mel_encoder" in r.tree:
        _conv_norms(sd, "mel_encoder", r, "mel_encoder")
        _bilstm(sd, "mel_encoder.lstm", r, "mel_encoder")
        _dense(sd, "mel_encoder.dense", r, "mel_encoder", "Dense_0")
        for i, name in enumerate(("prob", "mean", "log_var")):
            if f"Dense_{i}" in r.node("gaussian_mixture"):
                _dense(sd, f"gaussian_mixture.{name}", r, "gaussian_mixture", f"Dense_{i}")
    r.finish()
    return sd
