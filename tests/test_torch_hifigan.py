"""The port's HiFi-GAN generator against the JAX one, same weights.

- the committed ``hifigan`` golden (``tests/fixtures/golden``) reproduces
  through converted weights;
- a narrow v1-shaped config (ResBlock1, rates (8,8,2,2), kernels
  (16,16,4,4), 32 initial channels) and a v3-shaped one (ResBlock2) with
  JAX init match the JAX ``Generator``, which runs its folded path
  (``folded_convs=True``) by default; the port runs plain convs.

Tolerance 1e-5 abs: f32 on the CPU in both, the same math in another order.
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from neuraltexttospeech_torch.convert import generator_from_flax  # noqa: E402
from neuraltexttospeech_torch.models import hifigan as port_hg  # noqa: E402
from neuraltexttospeech_tpu.models import hifigan as jax_hg  # noqa: E402
from tools.make_goldens import FAMILIES, GOLDEN_DIR  # noqa: E402

GOLDEN_CFG = dict(resblock="2", upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                  upsample_initial_channel=32, resblock_kernel_sizes=(3,),
                  resblock_dilation_sizes=((1, 2),), n_fft=64, hop_size=16,
                  win_size=64, num_mels=8)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _port_generator(params, **cfg):
    gen = port_hg.Generator(port_hg.HiFiGANConfig(**cfg)).eval()
    gen.load_state_dict(generator_from_flax(params))
    return gen


def test_golden_reproduces():
    from flax import serialization

    variables, _ = FAMILIES["hifigan"](train=False)
    restored = serialization.from_bytes(variables,
                                        (GOLDEN_DIR / "hifigan.msgpack").read_bytes())
    golden = np.load(GOLDEN_DIR / "hifigan_golden.npz")
    mel = np.random.default_rng(101).standard_normal((2, 10, 8)).astype(np.float32)
    gen = _port_generator(jax.tree_util.tree_map(np.asarray, restored), **GOLDEN_CFG)
    with torch.no_grad():
        audio = gen(torch.as_tensor(mel)).numpy()
    assert audio.shape == golden["audio"].shape == (2, 160, 1)
    np.testing.assert_allclose(audio, golden["audio"], atol=1e-5, rtol=0)


NARROW = {
    "v1_shaped": dict(upsample_initial_channel=32),
    "v3_shaped": dict(resblock="2", upsample_rates=(8, 8, 4),
                      upsample_kernel_sizes=(16, 16, 8), upsample_initial_channel=32,
                      resblock_kernel_sizes=(3, 5, 7),
                      resblock_dilation_sizes=((1, 2), (2, 6), (3, 12))),
}


@pytest.mark.parametrize("name", sorted(NARROW))
def test_generator_matches_jax_folded_path(name):
    cfg = NARROW[name]
    jax_cfg = jax_hg.HiFiGANConfig(**cfg)
    assert jax_cfg.folded_convs
    mel = np.random.default_rng(7).standard_normal((2, 12, 80)).astype(np.float32)
    model = jax_hg.Generator(jax_cfg)
    params = model.init(jax.random.PRNGKey(3), jnp.asarray(mel))
    ref = np.asarray(model.apply(params, jnp.asarray(mel)))
    gen = _port_generator(jax.tree_util.tree_map(np.asarray, params), **cfg)
    with torch.no_grad():
        ours = gen(torch.as_tensor(mel)).numpy()
    assert ours.shape == ref.shape == (2, 12 * jax_cfg.total_upsample, 1)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("k,u", [(16, 8), (4, 2), (8, 4), (8, 8)])
def test_transpose_padding_gives_same_length(k, u):
    conv = torch.nn.ConvTranspose1d(2, 3, k, stride=u, padding=port_hg.transpose_padding(k, u))
    assert conv(torch.zeros(1, 2, 10)).shape[-1] == 10 * u


@pytest.mark.parametrize("k,u", [(7, 2), (2, 4)])
def test_transpose_padding_refuses_asymmetric_cases(k, u):
    with pytest.raises(ValueError):
        port_hg.transpose_padding(k, u)


def test_configs_match_jax():
    for v in ("v1", "v2", "v3"):
        ours, ref = getattr(port_hg.HiFiGANConfig, v)(), getattr(jax_hg.HiFiGANConfig, v)()
        for f in ("resblock", "upsample_rates", "upsample_kernel_sizes",
                  "upsample_initial_channel", "resblock_kernel_sizes",
                  "resblock_dilation_sizes", "num_mels", "n_fft", "hop_size",
                  "win_size", "sampling_rate", "fmin", "fmax"):
            assert getattr(ours, f) == getattr(ref, f), (v, f)
        assert ours.total_upsample == ref.total_upsample
