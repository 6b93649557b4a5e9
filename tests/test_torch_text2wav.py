"""The port's serving wiring end to end against the JAX package.

- text → wav: the composed ``text2wav`` golden's params, converted, go
  through the port's serving loop (``cli.fastpitch_infer.synthesize``) and
  reproduce ``text2wav_golden.npz``: ``dec_lens`` exactly, mel and audio to
  1e-4 abs (the golden test itself holds 1e-5 between JAX runs; the port
  sums in another order).
- copy-synthesis: a wav through the port's CPU ``hifigan_infer`` path
  against the JAX CLI's ``_iter_mels`` + ``Generator`` on a tiny config.
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from neuraltexttospeech_torch.cli import fastpitch_infer, hifigan_infer  # noqa: E402
from neuraltexttospeech_torch.convert import (  # noqa: E402
    fastpitch_from_flax, generator_from_flax,
)
from neuraltexttospeech_torch.data.filelist import save_wav  # noqa: E402
from neuraltexttospeech_torch.models.fastpitch import FastPitch, FastPitchConfig  # noqa: E402
from neuraltexttospeech_torch.models.hifigan import Generator, HiFiGANConfig  # noqa: E402
from neuraltexttospeech_torch.models.registry import save_checkpoint  # noqa: E402
from neuraltexttospeech_torch.text.processing import TextProcessing  # noqa: E402
from tools.make_goldens import FAMILIES, GOLDEN_DIR  # noqa: E402

CPU = torch.device("cpu")
GOLDEN_FP = dict(symbols_embedding_dim=64, in_fft_n_layers=1, in_fft_d_head=16,
                 in_fft_n_heads=2, in_fft_conv1d_filter_size=128, out_fft_n_layers=1,
                 out_fft_d_head=16, out_fft_n_heads=2, out_fft_conv1d_filter_size=128,
                 dur_predictor_filter_size=32, pitch_predictor_filter_size=32,
                 energy_predictor_filter_size=32)
TINY_HG = dict(resblock="2", upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
               upsample_initial_channel=32, resblock_kernel_sizes=(3,),
               resblock_dilation_sizes=((1, 2),), n_fft=64, hop_size=16,
               win_size=64, num_mels=8)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def golden_models():
    """The text2wav golden's flax params, and the port models built from them."""
    from flax import serialization

    variables, _ = FAMILIES["text2wav"](train=False)
    restored = serialization.from_bytes(variables,
                                        (GOLDEN_DIR / "text2wav.msgpack").read_bytes())
    restored = jax.tree_util.tree_map(np.asarray, restored)
    fp = FastPitch(FastPitchConfig(**GOLDEN_FP)).eval()
    fp.load_state_dict(fastpitch_from_flax(restored["fastpitch"]))
    gen = Generator(HiFiGANConfig(**dict(TINY_HG, num_mels=80))).eval()
    gen.load_state_dict(generator_from_flax(restored["hifigan"]))
    return restored, fp, gen


def _encoded():
    tp = TextProcessing("english_basic", ["english_cleaners_v2"], p_arpabet=0.0)
    return [np.asarray(tp.encode_text("The quick brown fox."), np.int32)]


def test_text2wav_golden_through_port_serving_loop(golden_models):
    _, fp, gen = golden_models
    golden = np.load(GOLDEN_DIR / "text2wav_golden.npz")
    (j, mel, audio), = fastpitch_infer.synthesize(
        fp, gen, _encoded(), device=CPU, batch_size=1, max_mel_len=128, text_bucket=1,
        frame_bucket=32)  # the golden's wiring: unpadded text
    assert j == 0
    dec_lens = golden["dec_lens"]
    assert mel.shape[0] == int(dec_lens[0]) and audio.shape == (int(dec_lens[0]) * 16,)
    np.testing.assert_allclose(mel[None], golden["mel"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(audio[None], golden["audio"], atol=1e-4, rtol=0)


@pytest.mark.parametrize("bucket,frames", [(1, 10), (16, 11)])
def test_text_bucket_sets_durations_as_in_jax(golden_models, bucket, frames):
    """Padding is not neutral: the predictors' second conv sees the first
    one's nonzero outputs at padded positions. The JAX CLI's 16-token
    bucket gives 11 frames where the unpadded golden has 10; the port
    follows JAX at each padding."""
    from neuraltexttospeech_tpu.models.fastpitch import FastPitch as JaxFastPitch
    from neuraltexttospeech_tpu.models.fastpitch import FastPitchConfig as JaxConfig
    from neuraltexttospeech_tpu.utils.serving import text_batches

    restored, fp, _ = golden_models
    (_, text, lens), = text_batches(_encoded(), 1, bucket)
    ref_mel, ref_lens = JaxFastPitch(JaxConfig(**GOLDEN_FP)).apply(
        restored["fastpitch"], jnp.asarray(text), jnp.asarray(lens), max_mel_len=128,
        method=JaxFastPitch.infer)[:2]
    (_, mel, _), = fastpitch_infer.synthesize(fp, None, _encoded(), device=CPU, batch_size=1,
                                              max_mel_len=128, text_bucket=bucket)
    assert int(ref_lens[0]) == mel.shape[0] == frames
    np.testing.assert_allclose(mel, np.asarray(ref_mel)[0, :frames], atol=1e-4, rtol=0)


def test_copy_synthesis_matches_jax_cli_path(tmp_path):
    from hifigan.inference import _iter_mels
    from neuraltexttospeech_tpu.models import hifigan as jax_hg

    rng = np.random.default_rng(11)
    t = np.arange(3000) / 22050
    wav = (0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(t.size))
    save_wav(str(tmp_path / "clip.wav"), wav.astype(np.float32), 22050)
    filelist = tmp_path / "list.txt"
    filelist.write_text(f"{tmp_path / 'clip.wav'}|some text\n")

    jax_cfg = jax_hg.HiFiGANConfig(**TINY_HG)
    (name, ref_mel), = list(_iter_mels(str(filelist), jax_cfg))
    model = jax_hg.Generator(jax_cfg)
    params = model.init(jax.random.PRNGKey(4), jnp.asarray(ref_mel)[None])
    ref_audio = np.asarray(model.apply(params, jnp.asarray(ref_mel)[None]))[0, :, 0]

    cfg = HiFiGANConfig(**TINY_HG)
    gen = Generator(cfg).eval()
    gen.load_state_dict(generator_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    (port_name, mel), = list(hifigan_infer.iter_mels(str(filelist), cfg, CPU))
    assert port_name == name == "clip"
    np.testing.assert_allclose(mel.numpy(), ref_mel, atol=1e-4, rtol=0)
    audio = hifigan_infer.vocode(gen, mel[None])[0].numpy()
    np.testing.assert_allclose(audio, ref_audio, atol=1e-5, rtol=0)

    # the CLI end to end, from a port checkpoint on disk
    save_checkpoint(tmp_path / "ckpt", "HiFiGAN", cfg, gen.state_dict())
    hifigan_infer.main(["--checkpoint", str(tmp_path / "ckpt"), "-i", str(filelist),
                        "-o", str(tmp_path / "out"), "--device", "cpu"])
    from scipy.io import wavfile

    _, pcm = wavfile.read(tmp_path / "out" / "clip.wav")
    ref_pcm = (np.clip(ref_audio, -1, 1) * 32767.0).astype(np.int16)
    assert pcm.shape == ref_pcm.shape
    assert np.abs(pcm.astype(np.int32) - ref_pcm).max() <= 1


def test_fastpitch_cli_writes_trimmed_outputs(tmp_path):
    """The text → wav CLI from port checkpoints on disk: every utterance gets
    a mel of dec_lens frames and a wav of dec_lens · hop samples."""
    from scipy.io import wavfile

    fp_cfg = FastPitchConfig(symbols_embedding_dim=32, in_fft_n_layers=1,
                             out_fft_n_layers=1, in_fft_d_head=16, out_fft_d_head=16,
                             in_fft_conv1d_filter_size=64, out_fft_conv1d_filter_size=64,
                             dur_predictor_filter_size=32, pitch_predictor_filter_size=32,
                             energy_predictor_filter_size=32)
    torch.manual_seed(0)
    fp = FastPitch(fp_cfg)
    with torch.no_grad():
        fp.duration_predictor.fc.bias.fill_(np.log(4.0))
    gen = Generator(HiFiGANConfig(**dict(TINY_HG, num_mels=80)))
    fe = {"symbol_set": "english_basic", "text_cleaners": ["english_cleaners_v2"],
          "p_arpabet": 0.0}
    save_checkpoint(tmp_path / "fp", "FastPitch", fp_cfg, fp.state_dict(), frontend=fe)
    save_checkpoint(tmp_path / "hg", "HiFiGAN", gen.config, gen.state_dict())
    lines = ["Hello world.", "A somewhat longer second sentence, to sort first last.",
             "Third."]
    (tmp_path / "in.txt").write_text("\n".join(lines) + "\n")
    fastpitch_infer.main(["--checkpoint", str(tmp_path / "fp"), "--hifigan-checkpoint",
                          str(tmp_path / "hg"), "-i", str(tmp_path / "in.txt"),
                          "-o", str(tmp_path / "out"), "--device", "cpu", "-bs", "2"])
    for j in range(len(lines)):
        mel = np.load(tmp_path / "out" / f"utt_{j:04d}_mel.npy")
        _, pcm = wavfile.read(tmp_path / "out" / f"utt_{j:04d}.wav")
        assert mel.shape[1] == 80 and mel.shape[0] > 0 and np.isfinite(mel).all()
        assert pcm.shape == (mel.shape[0] * 16,)


def test_serving_loop_handles_a_batch_with_no_frames(golden_models):
    """Durations that all round to 0 give empty mels and empty audio."""
    _, fp, gen = golden_models
    silent = FastPitch(fp.config).eval()
    silent.load_state_dict(fp.state_dict())
    with torch.no_grad():
        silent.duration_predictor.fc.bias.fill_(-20.0)
    (j, mel, audio), = fastpitch_infer.synthesize(silent, gen, _encoded(), device=CPU,
                                                  batch_size=2)
    assert j == 0 and mel.shape == (0, 80) and audio.shape == (0,)
