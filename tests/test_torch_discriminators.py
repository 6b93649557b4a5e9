"""The port's MPD and MSD against the JAX package's, same weights, on the CPU.

Parameters (weight norm kept as ``v`` and ``scale``) and the MSD's
spectral-norm stats are carried across by ``convert.hifigan_train_from_flax``.
Scores, feature maps and the stats after an ``update_stats=True`` call are
compared for the ``stock`` MSD (plain grouped convs) and ``gdot_pallas``
(the gouter path; on the CPU kernel B2's twin, in JAX the XLA tap loop), at
rtol 2e-4 / atol 2e-5 (``tests/test_fastconv.py:359-362``): f32 on the CPU in
both, the same sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraltexttospeech_torch.convert import hifigan_train_from_flax
from neuraltexttospeech_torch.models import hifigan as port_hg
from neuraltexttospeech_tpu.models import hifigan as jax_hg

TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _audio(seed, length, batch=2):
    return (np.random.default_rng(seed).standard_normal((batch, length, 1)) * 0.1).astype(
        np.float32)


def _like_jax(port: torch.Tensor, ref: np.ndarray) -> np.ndarray:
    """A port feature map in the JAX layout: plain [B, C, L] → [B, L, C];
    the MPD's [B*p, C, L'] → [B, L', p, C]; gouter maps are the same."""
    a = port.detach().numpy()
    if ref.ndim == 3:
        return a.transpose(0, 2, 1)
    if a.ndim == 4:
        return a
    b, length, p, c = ref.shape
    return a.reshape(b, p, c, length).transpose(0, 3, 1, 2)


def _compare(port_out, jax_out):
    for kind, (ours, ref) in enumerate(zip(port_out, jax_out)):
        if kind < 2:  # scores: one [B, N] per discriminator
            for a, b in zip(ours, ref):
                np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)
        else:         # fmaps
            for la, lb in zip(ours, ref):
                assert len(la) == len(lb)
                for a, b in zip(la, lb):
                    b = np.asarray(b)
                    np.testing.assert_allclose(_like_jax(a, b), b, **TOL)


@pytest.mark.parametrize("length", [256, 250])
def test_mpd_matches_jax(length):
    y, yh = _audio(0, length), _audio(1, length)
    mpd = jax_hg.MultiPeriodDiscriminator()
    params = mpd.init(jax.random.PRNGKey(0), jnp.asarray(y), jnp.asarray(yh))
    want = mpd.apply(params, jnp.asarray(y), jnp.asarray(yh))
    _, mpd_sd, _ = _convert(mpd_params=params["params"])
    port = port_hg.MultiPeriodDiscriminator()
    port.load_state_dict(mpd_sd)
    with torch.no_grad():
        got = port(torch.as_tensor(y), torch.as_tensor(yh))
    _compare(got, want)


_TREES = {}


def _trees():
    """JAX train-state trees of the TINY GAN config (full MPD/MSD)."""
    if not _TREES:
        from neuraltexttospeech_tpu.models.hifigan_gan import init_hifigan

        cfg = jax_hg.HiFiGANConfig(
            resblock="2", upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
            upsample_initial_channel=32, resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 2),), n_fft=64, hop_size=16, win_size=64,
            segment_size=256, num_mels=8)
        st = init_hifigan(cfg, jax.random.PRNGKey(0))
        _TREES.update(gen=_np(st.gen_params), mpd=_np(st.mpd_params),
                      msd=_np(st.msd_params), stats=_np(st.msd_stats))
    return _TREES


def _convert(mpd_params=None):
    t = _trees()
    return hifigan_train_from_flax(t["gen"], t["mpd"] if mpd_params is None else
                                   _np(mpd_params), t["msd"], t["stats"])


@pytest.mark.parametrize("impl", ["stock", "gdot_pallas"])
@pytest.mark.parametrize("length", [256, 100])
def test_msd_matches_jax_and_updates_stats_as_flax(impl, length):
    """Scores, fmaps and, after ``update_stats=True`` over a real and a fake
    pass, the spectral-norm ``u`` and ``sigma`` (the fake pass starts from
    the ``u`` the real pass wrote)."""
    t = _trees()
    y, yh = _audio(2, length), _audio(3, length)
    msd = jax_hg.MultiScaleDiscriminator(group_impl=impl)
    want, new_vars = msd.apply({"params": t["msd"], "batch_stats": t["stats"]},
                               jnp.asarray(y), jnp.asarray(yh), update_stats=True,
                               mutable=["batch_stats"])
    _, _, msd_sd = _convert()
    port = port_hg.MultiScaleDiscriminator(port_hg.resolve_msd_group_impl(impl))
    port.load_state_dict(msd_sd)
    with torch.no_grad():
        got = port(torch.as_tensor(y), torch.as_tensor(yh), update_stats=True)
    _compare(got, want)
    stats = new_vars["batch_stats"]["DiscriminatorS_0"]
    sn = port.discriminators[0].sn
    for j in range(8):
        entry = stats[f"SpectralNorm_{j}"]
        np.testing.assert_allclose(sn[j].u.numpy(), np.asarray(entry[f"Conv_{j}/kernel/u"]),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(sn[j].sigma.numpy(),
                                   np.asarray(entry[f"Conv_{j}/kernel/sigma"]), rtol=1e-5)


def test_msd_without_update_stats_leaves_them():
    _, _, msd_sd = _convert()
    port = port_hg.MultiScaleDiscriminator("stock")
    port.load_state_dict(msd_sd)
    before = {k: v.clone() for k, v in port.state_dict().items() if ".sn." in k}
    y = torch.as_tensor(_audio(4, 128))
    with torch.no_grad():
        a = port.scores(y)[0]
        b = port.scores(y)[0]
    for k, v in port.state_dict().items():
        if ".sn." in k:
            torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    for x, z in zip(a, b):
        torch.testing.assert_close(x, z, rtol=0, atol=0)


def test_msd_layer_plan_names_the_gouter_layers():
    """At a v1 segment (8192 samples) the five grouped layers of each scale
    take the gouter path; the g=1 layers never do."""
    specs = port_hg.DiscriminatorS.SPECS
    assert specs == jax_hg.DiscriminatorS.SPECS
    assert (port_hg.DiscriminatorS._folded_schedule(specs)
            == jax_hg.DiscriminatorS._folded_schedule(specs))
    d = port_hg.DiscriminatorS(group_impl="gouter")
    for length in (8192, 4096, 2048):
        plan = d.layer_plan(length)
        assert [use is not None for _, use, _ in plan] == [False] + [True] * 5 + [False]
    assert sum(use is not None for _, use, _ in d.layer_plan(64)) == 2
    assert all(use is None for _, use, _ in
               port_hg.DiscriminatorS(group_impl="stock").layer_plan(8192))


def test_losses_match_jax():
    rng = np.random.default_rng(5)
    dr = [rng.standard_normal((2, n)).astype(np.float32) for n in (3, 5)]
    dg = [rng.standard_normal((2, n)).astype(np.float32) for n in (3, 5)]
    fr = [[rng.standard_normal((2, 4, 3)).astype(np.float32) for _ in range(2)]]
    fg = [[rng.standard_normal((2, 4, 3)).astype(np.float32) for _ in range(2)]]
    T = lambda xs: [torch.as_tensor(x) for x in xs]  # noqa: E731
    np.testing.assert_allclose(
        float(port_hg.feature_loss([T(fr[0])], [T(fg[0])])),
        float(jax_hg.feature_loss(fr, fg)), rtol=1e-6)
    np.testing.assert_allclose(float(port_hg.discriminator_loss(T(dr), T(dg))[0]),
                               float(jax_hg.discriminator_loss(dr, dg)[0]), rtol=1e-6)
    np.testing.assert_allclose(float(port_hg.generator_loss(T(dg))[0]),
                               float(jax_hg.generator_loss(dg)[0]), rtol=1e-6)


@pytest.mark.parametrize("fast,impl", [(None, "gouter"), ("gdot", "gouter"),
                                       ("gdot_pallas", "gouter"), (False, "stock"),
                                       ("stock", "stock")])
def test_group_impl_resolution(fast, impl):
    assert port_hg.resolve_msd_group_impl(fast) == impl


@pytest.mark.parametrize("fast", [True, "bgc", "folded"])
def test_tpu_lowerings_are_not_ported(fast):
    with pytest.raises(NotImplementedError, match="TPU lowering"):
        port_hg.resolve_msd_group_impl(fast)
    with pytest.raises(ValueError):
        port_hg.resolve_msd_group_impl("gmajor")


def test_train_conversion_consumes_every_leaf():
    t = _trees()
    msd = {**t["msd"], "DiscriminatorS_1": {**t["msd"]["DiscriminatorS_1"],
                                            "stray": np.zeros(3, np.float32)}}
    with pytest.raises(ValueError, match="stray"):
        hifigan_train_from_flax(t["gen"], t["mpd"], msd, t["stats"])
    stats = {"DiscriminatorS_0": {**t["stats"]["DiscriminatorS_0"],
                                  "extra": {"x": np.zeros(1, np.float32)}}}
    with pytest.raises(ValueError, match="extra"):
        hifigan_train_from_flax(t["gen"], t["mpd"], t["msd"], stats)
