"""One HiFi-GAN GAN step in bf16 against the JAX package's, on the CPU.

``HiFiGANTrainer(dtype=torch.bfloat16)`` at ``TINY`` (``tests/test_hifigan.py:16-21``,
the full MPD and MSD; the MSD through B2's bf16 twin) against
``hifigan_train_step`` with ``dtype=jnp.bfloat16`` and JAX's default
``gdot`` MSD, from the same weights and batch: the metrics by the bf16
yardstick of ``test_torch_bf16.py`` (e_port <= 2 e_jax + 1e-3 max |jax_f32|,
printed by ``pytest -s``), and so are each network's gradients (the whole
gradient and the median over parameters, ``grads_yardstick``; JAX's read
from its Adams' first moments, the port's from ``.grad``); each updated parameter within ``2.5 lr + 1e-6`` of JAX's, the
spectral-norm stats, which both compute in f32 from the f32 weights, at the
f32 tolerance, and every parameter and Adam moment f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bf16 import _np, _param_bound, adam_grads, grads_yardstick, yardstick

from neuraltexttospeech_torch.convert import hifigan_train_from_flax
from neuraltexttospeech_torch.models import hifigan as port_hg
from neuraltexttospeech_tpu.models import hifigan as jax_hg

CPU = torch.device("cpu")
TINY = dict(resblock="2", upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
            upsample_initial_channel=32, resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 2),), n_fft=64, hop_size=16, win_size=64,
            segment_size=256, num_mels=8)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _initial_state(config, seed):
    """``init_hifigan``'s state without compiling its three inits: the
    structure from ``jax.eval_shape``, the values drawn with numpy as flax
    draws them (kernels lecun-normal, biases 0, weight-norm scales 1, the
    spectral-norm ``u`` standard normal and ``sigma`` 1, optimizer state
    and step 0)."""
    from neuraltexttospeech_tpu.models import hifigan_gan as jax_gan

    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jax_gan.init_hifigan(config, k), jax.random.PRNGKey(0))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "_opt" in name or name.startswith(".step") or name.endswith("bias']"):
            return jnp.zeros(leaf.shape, leaf.dtype)
        if name.endswith(("scale']", "sigma']")):
            return jnp.ones(leaf.shape, leaf.dtype)
        std = 1.0 if name.endswith("/u']") else np.prod(leaf.shape[:-1]) ** -0.5
        return jnp.asarray(rng.standard_normal(leaf.shape) * std, leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def test_gan_step_bf16_matches_jax():
    from concurrent.futures import ThreadPoolExecutor

    from neuraltexttospeech_torch.models import hifigan_gan as port_gan
    from neuraltexttospeech_tpu.models import hifigan_gan as jax_gan

    rng = np.random.default_rng(7)
    batch = {"mel": rng.standard_normal((2, 16, 8)).astype(np.float32),
             "audio": (rng.standard_normal((2, 256, 1)) * 0.1).astype(np.float32)}
    batch["mel_loss"] = np.asarray(jax_gan.mel_for_loss(
        jnp.asarray(batch["audio"][..., 0]), jax_gan.loss_stft_config(jax_hg.HiFiGANConfig(**TINY))))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    # the initial state does not depend on the compute dtype; each step
    # takes a copy (the jitted step donates its state)
    state = _initial_state(jax_hg.HiFiGANConfig(**TINY), 0)
    start = _np((state.gen_params, state.mpd_params, state.msd_params, state.msd_stats))

    def compiled(dt):  # JAX's default (gdot) MSD
        cfg = jax_hg.HiFiGANConfig(**TINY, dtype=dt)
        return jax_gan.hifigan_train_step_jitted.lower(
            cfg, jax_gan.resolve_msd_group_impl(cfg, jbatch), state, jbatch).compile()

    dtypes = (jnp.bfloat16, None)
    with ThreadPoolExecutor(2) as pool:  # one compiles while the other traces
        steps = dict(zip(dtypes, pool.map(compiled, dtypes)))
    out = {dt: steps[dt](jax.tree_util.tree_map(jnp.copy, state), jbatch) for dt in dtypes}
    trainer = port_gan.HiFiGANTrainer(port_hg.HiFiGANConfig(**TINY), CPU,
                                      dtype=torch.bfloat16)
    assert trainer.msd_group_impl == "gouter"
    for module, sd in zip((trainer.gen, trainer.mpd, trainer.msd),
                          hifigan_train_from_flax(*start)):
        module.load_state_dict(sd)
    got = trainer.train_step({k: torch.tensor(v) for k, v in batch.items()})
    (state_b, want_b), (state_f, want_f) = out[jnp.bfloat16], out[None]
    assert sorted(got) == sorted(want_b)
    for k in want_b:
        assert got[k].dtype == torch.float32
        yardstick(f"GAN step {k}", float(got[k]), float(want_b[k]), float(want_f[k]))
    ref = hifigan_train_from_flax(_np(state_b.gen_params), _np(state_b.mpd_params),
                                  _np(state_b.msd_params), _np(state_b.msd_stats))
    b1 = trainer.config.adam_b1
    grads = [hifigan_train_from_flax(*(adam_grads(st.gen_opt, b1), adam_grads(st.mpd_opt, b1),
                                       adam_grads(st.msd_opt, b1), _np(st.msd_stats)))
             for st in (state_b, state_f)]
    lr = trainer.config.learning_rate
    for i, (name, module) in enumerate(zip(("G", "MPD", "MSD"),
                                           (trainer.gen, trainer.mpd, trainer.msd))):
        ours = {k: p.grad.numpy() for k, p in module.named_parameters()}
        grads_yardstick(f"GAN step {name} gradients", ours,
                        *({k: g[i][k].numpy() for k in ours} for g in grads))
    for name, module, sd in zip(("G", "MPD", "MSD"), (trainer.gen, trainer.mpd, trainer.msd), ref):
        ours = module.state_dict()
        assert all(v.dtype == torch.float32 for v in ours.values())
        stats = {k for k in sd if ".sn." in k}
        for k in stats:
            np.testing.assert_allclose(ours[k].numpy(), sd[k].numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=k)
        _param_bound(f"GAN step {name} parameters", ours,
                     {k: v for k, v in sd.items() if k not in stats}, lr)
    for opt in trainer.optimizers.values():
        assert all(t.dtype == torch.float32 for s in opt.state.values() for t in s.values()
                   if torch.is_tensor(t) and t.is_floating_point())
