"""The port's DiffWave (``models/diffwave.py``) against the JAX package's, on
the CPU, same weights and inputs.

- the committed ``diffwave`` golden (``tools/make_goldens.py:130-159``)
  through ``convert.diffwave_from_flax``: the noise estimate at the goldens'
  1e-5;
- the step embedding: the table equal to JAX's, integer and fractional
  steps at 1e-6;
- the mel upsampler against both flax forms (``nn.ConvTranspose`` and the
  stencil twin), at odd and even frame and mel counts, 1e-5;
- forward and loss, conditional and unconditional, with JAX's ``t`` and
  noise (its key splits reproduced here) fed to the port: 1e-5;
- the sampling schedule, exactly; a 6-step sample with JAX's start and
  per-step noise fed in: 1e-5;
- bf16 (``--amp``): the forward by the yardstick of ``test_torch_bf16.py``.

``pytest -s`` prints each comparison's largest difference.
"""

import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from neuraltexttospeech_torch.convert import diffwave_from_flax  # noqa: E402
from neuraltexttospeech_torch.models import diffwave as port_dw  # noqa: E402
from neuraltexttospeech_torch.nn.precision import compute_dtype  # noqa: E402
from neuraltexttospeech_tpu.models import diffwave as jax_dw  # noqa: E402
from test_torch_bf16 import yardstick  # noqa: E402
from tools.make_goldens import GOLDEN_DIR  # noqa: E402

# the golden's small DiffWave (tools/make_goldens.py:137-138)
SMALL = dict(residual_layers=4, residual_channels=8, dilation_cycle_length=2, crop_mel_frames=4)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(what, got, want, atol=1e-5, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    print(f"{what}: max |port - JAX| {np.abs(got - want).max():.3e} (max |JAX| "
          f"{np.abs(want).max():.3e})")
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=what)


def _port(params, **cfg):
    model = port_dw.DiffWave(port_dw.DiffWaveConfig(**cfg)).eval()
    model.load_state_dict(diffwave_from_flax(params))
    return model


@pytest.fixture(scope="module")
def golden():
    """The golden's flax params and inputs (rng 102, as make_goldens draws them)."""
    from flax import serialization

    params = serialization.msgpack_restore((GOLDEN_DIR / "diffwave.msgpack").read_bytes())
    rng = np.random.default_rng(102)
    audio = (rng.standard_normal((2, 4 * 256)) * 0.1).astype(np.float32)
    mel = rng.standard_normal((2, 4, 80)).astype(np.float32)
    return params, audio, mel


@pytest.fixture(scope="module")
def unconditional():
    """A random unconditional DiffWave, its output projection made nonzero
    (flax zero-initialises it, which would hide the whole network)."""
    cfg = jax_dw.DiffWaveConfig(**SMALL, unconditional=True)
    audio = jnp.zeros((2, 1024))
    params = _np(jax_dw.DiffWave(cfg).init(jax.random.PRNGKey(5), audio,
                                           jnp.zeros((2,), jnp.int32), None))
    rng = np.random.default_rng(6)
    out = params["params"]["Conv_2"]
    out["kernel"] = (rng.standard_normal(out["kernel"].shape) * 0.3).astype(np.float32)
    out["bias"] = np.full_like(out["bias"], 0.01)
    return cfg, params


def test_golden_reproduces(golden):
    params, audio, mel = golden
    want = np.load(GOLDEN_DIR / "diffwave_golden.npz")["eps"]
    with torch.no_grad():
        got = _port(params, **SMALL)(torch.as_tensor(audio), torch.tensor([3, 17]),
                                     torch.as_tensor(mel))
    _close("diffwave golden eps", got.numpy(), want)


def test_step_embedding_matches_jax():
    emb = jax_dw.DiffusionEmbedding(50)
    t_int = jnp.asarray([0, 7, 49], jnp.int32)
    variables = _np(emb.init(jax.random.PRNGKey(3), t_int))
    port = port_dw.DiffusionEmbedding(50)
    sd = {f"projection{i + 1}.{k}": torch.as_tensor(
        (v.T if k == "kernel" else v).copy()) for i in range(2)
        for k, v in variables["params"][f"Dense_{i}"].items()}
    port.load_state_dict({k.replace("kernel", "weight"): v for k, v in sd.items()})
    np.testing.assert_array_equal(port.table.numpy(), np.asarray(emb._table()))
    for t in (t_int, jnp.asarray([0.0, 3.25, 12.7, 48.999], jnp.float32)):
        with torch.no_grad():
            got = port(torch.as_tensor(np.asarray(t)))
        _close(f"step embedding at {np.asarray(t)}", got.numpy(),
               emb.apply(variables, t), atol=1e-6, rtol=1e-6)


class _FlaxUpsampler(flax_nn.Module):
    """The flax layer the JAX package's stencil replaces
    (``tests/test_diffwave_upsampler.py``)."""

    @flax_nn.compact
    def __call__(self, x):
        x = x[..., None]
        for _ in range(2):
            x = flax_nn.ConvTranspose(1, (32, 3), strides=(16, 1), padding="SAME",
                                      transpose_kernel=True)(x)
            x = flax_nn.leaky_relu(x, 0.4)
        return x[..., 0]


@pytest.mark.parametrize("F,M", [(9, 80), (62, 80), (4, 7), (5, 3)])
def test_upsampler_matches_both_flax_forms(F, M):
    x = jax.random.normal(jax.random.PRNGKey(F * M), (2, F, M))
    variables = _np(_FlaxUpsampler().init(jax.random.PRNGKey(1), x))
    # a bias makes the padding's zeros count
    for i in range(2):
        variables["params"][f"ConvTranspose_{i}"]["bias"] = np.asarray([0.1 * (i + 1)],
                                                                       np.float32)
    port = port_dw.SpectrogramUpsampler()
    port.load_state_dict({f"conv{i + 1}.{k}": v for i in range(2) for k, v in (
        ("weight", torch.as_tensor(variables["params"][f"ConvTranspose_{i}"]["kernel"]
                                   .transpose(3, 2, 0, 1).copy())),
        ("bias", torch.as_tensor(variables["params"][f"ConvTranspose_{i}"]["bias"])))})
    with torch.no_grad():
        got = port(torch.as_tensor(np.asarray(x))).numpy()
    assert got.shape == (2, F * 256, M)
    _close(f"upsampler vs flax ConvTranspose F={F} M={M}", got,
           _FlaxUpsampler().apply(variables, x))
    _close(f"upsampler vs the stencil twin F={F} M={M}", got,
           jax_dw.SpectrogramUpsampler().apply(variables, x))


def _jax_loss_draws(key, batch, length, num_steps):
    """``diffwave_loss``'s draws: ``t`` and the noise from ``split(key)``."""
    t_rng, n_rng = jax.random.split(key)
    return (np.asarray(jax.random.randint(t_rng, (batch,), 0, num_steps)),
            np.asarray(jax.random.normal(n_rng, (batch, length))))


@pytest.mark.parametrize("mode", ["conditional", "unconditional"])
def test_forward_and_loss_match_jax(mode, golden, unconditional):
    if mode == "conditional":
        params, audio, mel = golden
        cfg = jax_dw.DiffWaveConfig(**SMALL)
    else:
        cfg, params = unconditional
        audio, mel = golden[1], None
    model = jax_dw.DiffWave(cfg)
    port = _port(params, **SMALL, unconditional=cfg.unconditional)
    mel_t = None if mel is None else torch.as_tensor(mel)
    for t in (np.asarray([0, 31], np.int32), np.asarray([2.5, 40.75], np.float32)):
        with torch.no_grad():
            got = port(torch.as_tensor(audio), torch.as_tensor(t), mel_t)
        _close(f"{mode} forward at t={t}", got.numpy(), model.apply(params, audio, t, mel))

    key = jax.random.PRNGKey(7)
    want_loss, want_metrics = jax_dw.diffwave_loss(model, params,
                                                   {"audio": audio, "mel": mel}, key)
    t, noise = _jax_loss_draws(key, 2, audio.shape[1], cfg.num_steps)
    with torch.no_grad():
        loss, metrics = port_dw.diffwave_loss(port, {"audio": torch.as_tensor(audio),
                                                     "mel": mel_t},
                                              t=torch.as_tensor(t), noise=torch.as_tensor(noise))
    _close(f"{mode} loss", float(loss), float(want_loss), atol=0, rtol=1e-5)
    assert sorted(metrics) == sorted(want_metrics) == ["l1_noise"]


def test_loss_draws_from_the_generator(golden):
    params, audio, mel = golden
    port = _port(params, **SMALL)
    batch = {"audio": torch.as_tensor(audio), "mel": torch.as_tensor(mel)}
    with torch.no_grad():
        a = port_dw.diffwave_loss(port, batch, torch.Generator().manual_seed(1))[0]
        b = port_dw.diffwave_loss(port, batch, torch.Generator().manual_seed(1))[0]
        c = port_dw.diffwave_loss(port, batch, torch.Generator().manual_seed(2))[0]
    assert float(a) == float(b) != float(c)


@pytest.mark.parametrize("fast", [True, False])
def test_sampling_schedule_matches_jax(fast):
    cfg = jax_dw.DiffWaveConfig()
    got = port_dw.sampling_schedule(port_dw.DiffWaveConfig(), fast)
    want = jax_dw.sampling_schedule(cfg, fast)
    assert len(got[0]) == (6 if fast else 50)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _jax_sample_draws(key, batch, length, steps):
    """``reverse_sample``'s draws: the start from the first half of
    ``split(key)``, then one normal a step from the running key's split."""
    init_rng, key = jax.random.split(key)
    audio0 = np.asarray(jax.random.normal(init_rng, (batch, length)))
    noise = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        noise.append(torch.as_tensor(np.asarray(jax.random.normal(sub, (batch, length)))))
    return torch.as_tensor(audio0), noise


@pytest.mark.parametrize("mode", ["conditional", "unconditional"])
def test_six_step_sample_matches_jax(mode, golden, unconditional):
    if mode == "conditional":
        params, _, mel = golden
        cfg = jax_dw.DiffWaveConfig(**SMALL)
        batch, length, audio_len = 2, mel.shape[1] * 256, None
    else:
        cfg, params = unconditional
        mel, batch, length, audio_len = None, 1, 512, 512
    key = jax.random.PRNGKey(11)
    want = jax_dw.reverse_sample(jax_dw.DiffWave(cfg), params, key, mel, fast_sampling=True,
                                 audio_len=audio_len)
    audio0, noise = _jax_sample_draws(key, batch, length, 6)
    got = port_dw.reverse_sample(_port(params, **SMALL, unconditional=cfg.unconditional),
                                 None if mel is None else torch.as_tensor(mel),
                                 fast_sampling=True, audio_len=audio_len, audio0=audio0,
                                 noise=noise)
    assert got.dtype == torch.float32 and got.abs().max() <= 1.0
    _close(f"{mode} 6-step sample", got.numpy(), want)


def test_folded_convs_is_refused():
    with pytest.raises(ValueError, match="TPU lowering"):
        port_dw.DiffWaveConfig(folded_convs=True)


def test_bf16_forward_matches_jax_by_the_yardstick(golden):
    params, audio, mel = golden
    t = np.asarray([3, 17], np.int32)
    want = {dt: np.asarray(jax_dw.DiffWave(jax_dw.DiffWaveConfig(**SMALL, dtype=dt)).apply(
        params, audio, t, mel), np.float32) for dt in (jnp.bfloat16, None)}
    port = _port(params, **SMALL)
    with torch.no_grad(), compute_dtype(torch.bfloat16):
        got = port(torch.as_tensor(audio), torch.as_tensor(t), torch.as_tensor(mel))
    assert got.dtype == torch.bfloat16  # the last conv computes in bf16, as flax's
    yardstick("DiffWave forward", got.float().numpy(), want[jnp.bfloat16], want[None])
    assert dataclasses.asdict(port.config)["folded_convs"] is False
