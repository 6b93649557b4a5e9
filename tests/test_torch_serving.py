"""Serving over several devices (``utils/serving.py``, the six text → mel CLIs).

- The contract: ``serving_sharding`` with N devices rounds the batch and
  places rows as JAX's ``serving_sharding`` does on the 8 virtual CPU devices
  of ``tests/conftest.py``; ``replicate`` gives every device a model of its
  own.
- Split vs one device: each CLI's ``synthesize`` on ``[cpu, cpu]`` (two
  replicas, two threads) equals itself on ``cpu`` at the same rounded batch,
  with the draws active (Grad-TTS's stochastic sampler, Flowtron's ``z``,
  Tacotron 2's prenet dropout), so a draw taken at a replica's shape instead
  of the batch's fails; one ``--amp`` case runs bf16 in the threads.
- Against JAX: FastPitch → HiFi-GAN on 8 CPU replicas equals the JAX CLI's
  jitted ``FastPitch.infer`` and generator sharded over the 8 virtual devices,
  on the ``text2wav`` golden's weights.
- The device policy: no device means every visible card, and raises
  without one (the CLIs' ``main``: ``tests/test_torch_import.py``).
"""

import pathlib
import sys
import threading

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from neuraltexttospeech_torch.cli import (  # noqa: E402
    fastpitch_infer, fastspeech2_infer, flowtron_infer, gradtts_infer, tacotron2_infer,
    talknet_infer,
)
from neuraltexttospeech_torch.models.hifigan import Generator, HiFiGANConfig  # noqa: E402
from neuraltexttospeech_torch.nn.precision import current as current_dtype  # noqa: E402
from neuraltexttospeech_torch.parallel import mesh  # noqa: E402
from neuraltexttospeech_torch.utils.device import resolve_devices  # noqa: E402
from neuraltexttospeech_torch.utils.serving import Replicas, serving_sharding  # noqa: E402

CPU = torch.device("cpu")
TWO = [CPU, CPU]
TINY_HG = dict(resblock="2", upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
               upsample_initial_channel=32, resblock_kernel_sizes=(3,),
               resblock_dilation_sizes=((1, 2),), n_fft=64, hop_size=16, win_size=64,
               num_mels=80)
LENGTHS = (5, 9, 12, 3, 17, 7)  # 6 utterances: a batch of 4 and a padded one


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _encoded(n_symbols, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, n_symbols, n).astype(np.int32) for n in LENGTHS]


@pytest.fixture(scope="module")
def models():
    """One tiny model of each family (and the tiny vocoder), shared by the
    cases: PyTorch's default init under fixed seeds, the duration heads'
    biases set so that utterances get a few frames a token."""
    from neuraltexttospeech_torch.models import (
        fastpitch as fp, fastspeech2 as fs2, flowtron as fl, gradtts as gt, tacotron2 as t2,
        talknet as tn,
    )

    out = {}
    torch.manual_seed(0)
    out["vocoder"] = Generator(HiFiGANConfig(**TINY_HG)).eval()
    out["fastpitch"] = fp.FastPitch(fp.FastPitchConfig(
        n_symbols=40, symbols_embedding_dim=32, in_fft_n_layers=1, in_fft_d_head=16,
        in_fft_n_heads=2, in_fft_conv1d_filter_size=64, out_fft_n_layers=1, out_fft_d_head=16,
        out_fft_n_heads=2, out_fft_conv1d_filter_size=64, dur_predictor_filter_size=32,
        pitch_predictor_filter_size=32, energy_predictor_filter_size=32)).eval()
    out["fastspeech2"] = fs2.FastSpeech2(fs2.FastSpeech2Config(
        n_symbols=40, encoder_layer=1, decoder_layer=1, encoder_hidden=32, decoder_hidden=32,
        conv_filter_size=64, variance_filter_size=16, n_bins=16, postnet_dim=24,
        postnet_layers=2)).eval()
    with torch.no_grad():
        for m in (out["fastpitch"], out["fastspeech2"]):
            m.duration_predictor.fc.bias.fill_(float(np.log(4.0)))
    bb = tn.QuartzNetConfig(module_repeat=1, block_params=((16, 5), (16, 5)), initial_filters=16,
                            initial_kernel=5, penultimate_filters=16, penultimate_kernel=5,
                            final_filters=32)
    cfg = tn.TalkNet2Config(n_symbols=40, emb_dim=32, backbone=bb)
    out["talknet"] = tuple(cls(cfg).eval() for cls in (tn.GraphemeDuration, tn.PitchPredictor,
                                                       tn.SpectrogramModel))
    with torch.no_grad():
        out["talknet"][0].backbone.out.bias.fill_(3.0)
    out["gradtts"] = gt.GradTTS(gt.GradTTSConfig(
        n_symbols=40, n_enc_channels=32, filter_channels=64, filter_channels_dp=32,
        n_enc_layers=1, dec_dim=8)).eval()
    out["flowtron"] = fl.Flowtron(fl.FlowtronConfig(
        n_text=40, n_text_dim=32, n_attn_channels=16, n_hidden=24, n_speaker_dim=8)).eval()
    out["tacotron2"] = t2.Tacotron2(t2.Tacotron2Config(
        n_symbols=40, symbols_embedding_dim=32, encoder_embedding_dim=32, decoder_rnn_dim=48,
        attention_rnn_dim=48, attention_dim=16, attention_location_n_filters=4, prenet_dim=16,
        postnet_embedding_dim=24, max_decoder_steps=20)).eval()
    return out


def _serve(family, models, device, batch_size, amp=False):
    """``synthesize`` of ``family`` with the tiny vocoder: [(index, mel,
    audio)] in yield order."""
    return list(_synthesize(family, models, device, batch_size, amp))


def _synthesize(family, models, device, batch_size, amp=False):
    """``synthesize`` of ``family`` with the tiny vocoder, as it yields
    ``(index, mel, audio)``; ``amp`` is its ``dtype=bfloat16``."""
    enc = _encoded(40)
    voc = models["vocoder"]
    dtype = torch.bfloat16 if amp else None
    if family == "fastpitch":
        it = fastpitch_infer.synthesize(models[family], voc, enc, device=device,
                                        batch_size=batch_size, max_mel_len=96, text_bucket=8,
                                        frame_bucket=1, dtype=dtype)
    elif family == "fastspeech2":
        it = fastspeech2_infer.synthesize(models[family], voc, enc, device=device,
                                          max_mel_len=96, batch_size=batch_size, dtype=dtype)
    elif family == "talknet":
        it = talknet_infer.synthesize(models[family], voc, enc, device=device, max_mel_len=64,
                                      batch_size=batch_size, dtype=dtype)
    elif family == "gradtts":
        it = (out[:3] for out in gradtts_infer.synthesize(
            models[family], voc, enc, device=device, n_timesteps=3, stoc=True,
            batch_size=batch_size, max_mel_len=48, frame_bucket=16, dtype=dtype))
    elif family == "flowtron":
        it = flowtron_infer.synthesize(models[family], voc, enc, device=device,
                                       batch_size=batch_size, n_frames=24, sigma=0.8,
                                       dtype=dtype)
    else:
        it = tacotron2_infer.synthesize(models[family], voc, enc, device=device,
                                        batch_size=batch_size, dtype=dtype)
    return it


@pytest.mark.parametrize("batch_size", [1, 5, 8, 9])
def test_serving_sharding_places_rows_as_jax(batch_size):
    import jax

    from neuraltexttospeech_tpu.utils.serving import serving_sharding as jax_sharding

    n = len(jax.devices())
    assert n == 8
    jput, _, jbs = jax_sharding(batch_size)
    put, _, bs = serving_sharding(batch_size, [CPU] * n)
    assert bs == jbs
    x = np.arange(bs * 3, dtype=np.int32).reshape(bs, 3)
    by_device = {s.device.id: s.index for s in jput(x).addressable_shards}
    chunks = put(x)
    assert len(chunks) == n
    for i, d in enumerate(jax.devices()):
        np.testing.assert_array_equal(chunks[i].numpy(), x[by_device[d.id]])


@pytest.mark.parametrize("device", [CPU, "cpu", [CPU]])
def test_one_device_serves_as_before(models, device):
    put, replicate, bs = serving_sharding(5, device)
    x = np.arange(10).reshape(5, 2)
    assert bs == 5 and [t.tolist() for t in put(x)] == [x.tolist()]
    assert replicate(models["vocoder"]) == [models["vocoder"]]


def test_replicate_gives_every_device_its_own_model(models):
    t2 = models["tacotron2"]
    _, replicate, _ = serving_sharding(4, TWO)
    first, second = replicate(t2)
    assert first is t2 and second is not t2 and not second.training
    ours = dict(t2.state_dict())
    for key, value in second.state_dict().items():  # parameters and buffers
        assert torch.equal(value, ours[key])
        assert value.untyped_storage().data_ptr() != ours[key].untyped_storage().data_ptr()
    heads = replicate(models["talknet"])
    assert heads[0] == models["talknet"]
    assert all(a is not b for a, b in zip(heads[1], models["talknet"]))


def test_replicas_enter_the_thread_local_settings():
    seen = {}

    def probe(i, x):
        seen[i] = (threading.get_ident(), torch.is_inference_mode_enabled(), current_dtype(),
                   mesh.current().n_data, mesh.current().data_index, x)
        with pytest.raises(RuntimeError, match="no process group"):
            mesh.global_count(torch.ones(()))
        return i

    with Replicas(TWO) as replicas:
        assert replicas.map(probe, ["a", "b"], dtype=torch.bfloat16) == [0, 1]
    assert seen[0][0] != seen[1][0] != threading.get_ident()
    assert [s[1:] for s in (seen[0], seen[1])] == [
        (True, torch.bfloat16, 2, 0, "a"), (True, torch.bfloat16, 2, 1, "b")]
    assert mesh.current() is None and current_dtype() is None


def test_a_replicas_exception_is_raised_in_the_caller():
    def fail_second(i):
        if i == 1:
            raise ValueError("replica 1 failed")
        return i

    with Replicas(TWO) as replicas, pytest.raises(ValueError, match="replica 1 failed"):
        replicas.map(fail_second)


def test_replica_draws_are_rows_of_the_global_draw():
    want = torch.rand((4, 3), generator=torch.Generator().manual_seed(3))

    def draw(i):
        return mesh.global_draw(torch.rand, (2, 3), torch.Generator().manual_seed(3))

    with Replicas(TWO) as replicas:
        got = torch.cat(replicas.map(draw))
    assert torch.equal(got, want)


FAMILIES = ["fastpitch", "fastspeech2", "talknet", "gradtts", "flowtron", "tacotron2"]


@pytest.mark.parametrize("family,amp", [(f, False) for f in FAMILIES] + [("fastpitch", True)])
def test_two_replicas_equal_one_device(models, family, amp):
    one = _serve(family, models, CPU, 4, amp)
    two = _serve(family, models, TWO, 3, amp)  # rounded up to 4
    assert [j for j, _, _ in one] == [j for j, _, _ in two] == [3, 0, 5, 1, 2, 4]
    for (_, mel1, audio1), (_, mel2, audio2) in zip(one, two):
        assert mel1.shape == mel2.shape and audio1.shape == audio2.shape
        assert mel1.shape[0] > 0 and np.isfinite(mel1).all() and np.isfinite(audio1).all()
        np.testing.assert_allclose(mel2, mel1, atol=1e-6, rtol=0)
        np.testing.assert_allclose(audio2, audio1, atol=1e-6, rtol=0)
    if amp:  # bf16 ran in the threads: the f32 run differs
        f32 = _serve(family, models, TWO, 3)
        assert max(np.abs(a[1] - b[1]).max() for a, b in zip(f32, two)
                   if a[1].shape == b[1].shape) > 1e-3


def test_fastpitch_on_8_replicas_equals_jax_sharded_serving():
    import jax
    import jax.numpy as jnp
    from flax import serialization

    from neuraltexttospeech_torch.convert import fastpitch_from_flax, generator_from_flax
    from neuraltexttospeech_torch.models.fastpitch import FastPitch, FastPitchConfig
    from neuraltexttospeech_tpu.models import hifigan as jax_hg
    from neuraltexttospeech_tpu.models.fastpitch import FastPitch as JaxFastPitch
    from neuraltexttospeech_tpu.models.fastpitch import FastPitchConfig as JaxFastPitchConfig
    from neuraltexttospeech_tpu.utils import serving as jax_serving
    from test_torch_text2wav import GOLDEN_FP
    from tools.make_goldens import GOLDEN_DIR

    tree = jax.tree_util.tree_map(np.asarray, serialization.msgpack_restore(
        (GOLDEN_DIR / "text2wav.msgpack").read_bytes()))
    hg_kw = dict(TINY_HG)
    fp = FastPitch(FastPitchConfig(**GOLDEN_FP)).eval()
    fp.load_state_dict(fastpitch_from_flax(tree["fastpitch"]))
    gen = Generator(HiFiGANConfig(**hg_kw)).eval()
    gen.load_state_dict(generator_from_flax(tree["hifigan"]))
    n_symbols = FastPitchConfig(**GOLDEN_FP).n_symbols
    encoded = _encoded(n_symbols, seed=1)
    max_mel, hop = 96, 16
    ours = list(fastpitch_infer.synthesize(fp, gen, encoded, device=[CPU] * 8, batch_size=5,
                                           max_mel_len=max_mel))

    # the JAX CLI's loop (fastpitch/inference.py): sharded over every device
    model = JaxFastPitch(JaxFastPitchConfig(**GOLDEN_FP))
    jgen = jax_hg.Generator(jax_hg.HiFiGANConfig(**hg_kw))
    synth_mel = jax.jit(lambda p, t, l: model.apply(p, t, l, max_mel_len=max_mel,
                                                    method=JaxFastPitch.infer)[:2])
    vocode = jax.jit(lambda p, m: jgen.apply(p, m).astype(jnp.float32))
    put, replicate, batch_size = jax_serving.serving_sharding(5)
    assert batch_size == 8
    params, gen_params = replicate(tree["fastpitch"]), replicate(tree["hifigan"])
    want = {}
    for idxs, text, lens in jax_serving.text_batches(encoded, batch_size):
        mel, dec_lens = synth_mel(params, put(text), put(lens))
        dec_lens = np.asarray(dec_lens)
        M = min(jax_serving.round_up(int(dec_lens[:len(idxs)].max()), 128), max_mel)
        audio = np.asarray(vocode(gen_params, mel[:, :M])[..., 0])
        for r, j in enumerate(idxs):
            n = int(dec_lens[r])
            want[j] = np.asarray(mel[r, :n]), audio[r, :n * hop]
    assert [j for j, _, _ in ours] == list(want)
    for j, mel, audio in ours:
        assert mel.shape == want[j][0].shape and audio.shape == want[j][1].shape
        assert mel.shape[0] > 0
        np.testing.assert_allclose(mel, want[j][0], atol=1e-4, rtol=0)
        np.testing.assert_allclose(audio, want[j][1], atol=1e-4, rtol=0)


def test_resolve_devices():
    assert resolve_devices("cpu") == [CPU]
    assert resolve_devices(TWO) == TWO
    assert resolve_devices(["cpu"] * 3) == [CPU] * 3


def test_resolve_devices_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_devices(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_devices([CPU, "cuda"])


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
def test_resolve_devices_without_a_device_is_every_visible_card():
    n = torch.cuda.device_count()
    assert resolve_devices(None) == [torch.device("cuda", i) for i in range(n)]
    assert resolve_devices("cuda") == [torch.device("cuda", torch.cuda.current_device())]
