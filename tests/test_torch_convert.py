"""``convert.py`` consumes every leaf of a flax tree, or raises.

FastPitch is initialised through the training forward, as the JAX CLI's
loader does, so its tree holds the ``attention`` (aligner) subtree that
the serving converter skips by name and the training converter carries.
"""

import copy
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraltexttospeech_torch.convert import (
    fastpitch_from_flax, fastpitch_train_from_flax, fold_weight_norm, generator_from_flax,
)
from neuraltexttospeech_torch.models import fastpitch as port_fp
from neuraltexttospeech_torch.models import hifigan as port_hg
from neuraltexttospeech_tpu.models import fastpitch as jax_fp
from neuraltexttospeech_tpu.models import hifigan as jax_hg

FP_KW = dict(n_symbols=30, symbols_embedding_dim=32, in_fft_n_layers=1, out_fft_n_layers=2,
             in_fft_d_head=16, out_fft_d_head=16, in_fft_conv1d_filter_size=64,
             out_fft_conv1d_filter_size=64, dur_predictor_filter_size=16,
             pitch_predictor_filter_size=16, energy_predictor_filter_size=16)
HG_KW = dict(upsample_initial_channel=16, upsample_rates=(4, 4),
             upsample_kernel_sizes=(8, 8), num_mels=8)


@pytest.fixture(scope="module")
def fastpitch_tree():
    cfg = jax_fp.FastPitchConfig(**FP_KW)
    text = jnp.ones((1, 8), jnp.int32)
    lens = jnp.full((1,), 8, jnp.int32)
    mel = jnp.zeros((1, 16, 80))
    mel_lens = jnp.full((1,), 16, jnp.int32)
    pitch = jnp.zeros((1, 1, 16))
    energy = jnp.zeros((1, 16))
    prior = jnp.ones((1, 16, 8))
    params = jax_fp.FastPitch(cfg).init(jax.random.PRNGKey(0), text, lens, mel, mel_lens,
                                        pitch, energy, None, prior)
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def generator_tree():
    params = jax_hg.Generator(jax_hg.HiFiGANConfig(**HG_KW)).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 6, 8)))
    return jax.tree_util.tree_map(np.asarray, params)


def test_fastpitch_tree_converts_completely(fastpitch_tree):
    assert "attention" in fastpitch_tree["params"]
    sd = fastpitch_from_flax(fastpitch_tree)
    port = port_fp.FastPitch(port_fp.FastPitchConfig(**FP_KW))
    port.load_state_dict(sd, strict=True)
    n_leaves = sum(a.size for k, a in _leaves(fastpitch_tree["params"])
                   if not k.startswith("attention/"))
    # the port's model has the aligner too; the serving conversion leaves it out
    assert n_leaves == sum(p.numel() for name, p in port.named_parameters()
                           if not name.startswith("attention."))
    train_sd = fastpitch_train_from_flax(fastpitch_tree)
    port.load_state_dict(train_sd, strict=True)
    assert sum(a.size for _, a in _leaves(fastpitch_tree["params"])) == sum(
        p.numel() for p in port.parameters())


def test_generator_tree_converts_completely(generator_tree):
    sd = generator_from_flax(generator_tree)
    port = port_hg.Generator(port_hg.HiFiGANConfig(**HG_KW))
    port.load_state_dict(sd, strict=True)
    n_scales = sum(a.size for k, a in _leaves(generator_tree["params"]) if "WeightNorm_" in k)
    n_leaves = sum(a.size for _, a in _leaves(generator_tree["params"]))
    assert n_leaves - n_scales == sum(p.numel() for p in port.parameters())


@pytest.mark.parametrize("where", [("encoder",), ("decoder", "blocks_0"), ()])
def test_unknown_fastpitch_leaf_raises(fastpitch_tree, where):
    tree = copy.deepcopy(fastpitch_tree)
    node = tree["params"]
    for k in where:
        node = node[k]
    node["bogus"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="bogus"):
        fastpitch_from_flax(tree)


def test_unknown_generator_leaf_raises(generator_tree):
    tree = copy.deepcopy(generator_tree)
    tree["params"]["ResBlock1_0"]["Conv_9"] = {"kernel": np.zeros((3, 2, 2), np.float32)}
    with pytest.raises(ValueError, match="Conv_9"):
        generator_from_flax(tree)


def test_missing_leaf_raises(fastpitch_tree):
    tree = copy.deepcopy(fastpitch_tree)
    del tree["params"]["proj"]["kernel"]
    with pytest.raises(KeyError, match="proj"):
        fastpitch_from_flax(tree)


def test_weight_norm_fold_matches_flax():
    """flax WeightNorm over a transposed conv normalises over in-features."""
    from flax import linen as nn

    class Wrapped(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.WeightNorm(nn.ConvTranspose(3, (4,), strides=(2,), padding="SAME",
                                                  transpose_kernel=True))(x)

    x = jnp.asarray(np.random.default_rng(0).standard_normal((1, 5, 6)), jnp.float32)
    layer = Wrapped()
    tree = jax.tree_util.tree_map(np.asarray, layer.init(jax.random.PRNGKey(0), x))["params"]
    assert set(tree["WeightNorm_0"]) == {"ConvTranspose_0/kernel/scale"}
    tree["WeightNorm_0"]["ConvTranspose_0/kernel/scale"] = np.linspace(
        0.5, 1.5, 6, dtype=np.float32)  # a non-trivial scale, one per in-feature
    ref = np.asarray(layer.apply({"params": tree}, x))
    folded = fold_weight_norm(tree)
    assert set(folded) == {"ConvTranspose_0"}
    conv = torch.nn.ConvTranspose1d(6, 3, 4, stride=2, padding=port_hg.transpose_padding(4, 2))
    with torch.no_grad():
        conv.weight.copy_(torch.tensor(folded["ConvTranspose_0"]["kernel"].transpose(2, 1, 0)))
        conv.bias.copy_(torch.tensor(folded["ConvTranspose_0"]["bias"]))
        ours = conv(torch.tensor(np.asarray(x)).transpose(1, 2)).transpose(1, 2).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-6)


def test_checkpoint_tool_writes_loadable_port_checkpoints(tmp_path, fastpitch_tree,
                                                          generator_tree):
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from neuraltexttospeech_torch.models.registry import (
        load_frontend_config, load_model_config,
    )
    from tools.jax_to_torch_checkpoint import export_fastpitch, export_hifigan

    fe = {"symbol_set": "english_basic", "text_cleaners": ["english_cleaners_v2"],
          "p_arpabet": 0.0}
    diff = export_fastpitch(jax_fp.FastPitchConfig(**FP_KW), fastpitch_tree,
                            tmp_path / "fp", frontend=fe)
    assert diff <= 1e-4
    name, cfg = load_model_config(tmp_path / "fp")
    assert name == "FastPitch" and cfg == port_fp.FastPitchConfig(**FP_KW)
    assert load_frontend_config(tmp_path / "fp") == fe
    diff = export_hifigan(jax_hg.HiFiGANConfig(**HG_KW), generator_tree, tmp_path / "hg")
    assert diff <= 1e-5
    name, cfg = load_model_config(tmp_path / "hg")
    assert name == "HiFiGAN" and cfg == port_hg.HiFiGANConfig(**HG_KW)


def _leaves(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, pre + k + "/")
        else:
            yield pre + k, np.asarray(v)
