"""Grad-TTS → HiFi-GAN serving in the port, end to end, on the CPU.

- ``cli/gradtts_infer.py`` at a tiny size (random Grad-TTS weights drawn in
  JAX's tree and converted, a tiny HiFi-GAN generator): the text front end,
  the blank interspersal, the 16-token buckets (a short last batch padded
  with dummy rows), the sampler, the f32 host boundary, the 128-frame
  vocoder bucket and the per-utterance trim. The CLI runs with
  ``--temperature 1e30``, so its terminal noise term vanishes and each mel
  must equal JAX's ``GradTTS`` synthesis of the same padded batch with zero
  noise (at 1e-5 of its size, as in ``test_torch_gradtts.py``); each wav
  must equal the port's generator on the bucketed mel, trimmed, within the
  16-bit PCM step;
- bf16 (``--amp``) on the ``gradtts`` golden's weights against JAX's
  ``dtype=bfloat16`` model: the encoder and the sampler by the yardstick of
  ``test_torch_bf16.py``, and the synthesis's lengths and alignment
  equal.
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from neuraltexttospeech_torch.cli import gradtts_infer  # noqa: E402
from neuraltexttospeech_torch.convert import gradtts_from_flax  # noqa: E402
from neuraltexttospeech_torch.models import gradtts as port_gt  # noqa: E402
from neuraltexttospeech_torch.models.hifigan import Generator, HiFiGANConfig  # noqa: E402
from neuraltexttospeech_torch.models.registry import save_checkpoint  # noqa: E402
from neuraltexttospeech_torch.nn.precision import compute_dtype  # noqa: E402
from neuraltexttospeech_tpu.models import gradtts as jax_gt  # noqa: E402
from neuraltexttospeech_tpu.utils.serving import text_batches  # noqa: E402
from test_torch_bf16 import yardstick  # noqa: E402
from test_torch_gradtts import SMALL, TINY_HG, _close, _restore, random_params  # noqa: E402

PHRASES = ["Hello world.", "The rain in Spain stays mainly in the plain.", "Good day."]
MAX_MEL = 64


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_gradtts_infer_end_to_end_matches_jax(tmp_path):
    from scipy.io import wavfile

    kw = {k: v for k, v in SMALL.items() if k != "n_symbols"}  # the english_basic set + blank
    cfg = jax_gt.GradTTSConfig(**kw)
    model = jax_gt.GradTTS(cfg)
    params = random_params(model, 8, jax.random.PRNGKey(0), np.ones((1, 16), np.int32),
                           np.full((1,), 16, np.int32), 1, max_mel_len=32)
    gt_dir = save_checkpoint(tmp_path / "gradtts", "GradTTS", port_gt.GradTTSConfig(**kw),
                             gradtts_from_flax(params))
    torch.manual_seed(0)
    gen = Generator(HiFiGANConfig(**TINY_HG)).eval()
    hg_dir = save_checkpoint(tmp_path / "hifigan", "HiFiGAN", HiFiGANConfig(**TINY_HG),
                             gen.state_dict())
    text = tmp_path / "phrases.txt"
    text.write_text("\n".join(PHRASES) + "\n")
    out = tmp_path / "out"
    gradtts_infer.main(["--checkpoint", str(gt_dir), "--hifigan-checkpoint", str(hg_dir),
                        "-i", str(text), "-o", str(out), "--timesteps", "2",
                        "--temperature", "1e30", "--max-mel-len", str(MAX_MEL), "-bs", "2",
                        "--hop-length", "16", "--device", "cpu"])

    encoded = gradtts_infer.encode(PHRASES, cfg.n_symbols)
    assert all(e[0] == cfg.n_symbols - 1 and len(e) % 2 == 1 for e in encoded)  # interspersed
    synth = jax.jit(lambda x, xl: model.apply(params, x, xl, 2, max_mel_len=MAX_MEL,
                                              noise=jnp.zeros((2, 80, MAX_MEL))))
    seen = 0
    for idxs, x, xl in text_batches(encoded, 2):
        _, dec, _, ylen = synth(x, xl)
        dec, ylen = np.asarray(dec, np.float32), np.asarray(ylen)
        M = min(-(-int(ylen[:len(idxs)].max()) // 128) * 128, MAX_MEL)
        with torch.no_grad():
            audio = gen(torch.as_tensor(dec[:, :M]))[..., 0].numpy()
        for r, j in enumerate(idxs):
            n = int(ylen[r])
            mel = np.load(out / f"utt_{j:04d}_mel.npy")
            assert mel.shape == (n, 80), (j, mel.shape, n)
            _close(f"gradtts_infer utterance {j} mel", mel, dec[r, :n], sampled=True)
            sr, wav = wavfile.read(out / f"utt_{j:04d}.wav")
            assert sr == 22050 and wav.shape == (n * 16,)
            want = np.clip(audio[r, :n * 16], -1.0, 1.0)
            np.testing.assert_allclose(wav / 32767.0, want, atol=1.5 / 32767.0)
            seen += 1
    assert seen == len(PHRASES)


def test_bf16_synthesis_matches_jax_by_the_yardstick():
    """The encoder and the sampler each by the yardstick, from the same
    inputs in both modes (a bf16 duration can cross an integer and shift the
    whole alignment, in JAX too, which would leave the yardstick nothing to
    hold), and the bf16 synthesis's lengths and alignment equal to JAX's."""
    params = _restore("gradtts")
    rng = np.random.default_rng(104)
    x = rng.integers(1, 40, (2, 11)).astype(np.int32)
    xl = np.asarray([11, 7], np.int32)
    noise = rng.standard_normal((2, 80, 32)).astype(np.float32)
    port = port_gt.GradTTS(port_gt.GradTTSConfig(**SMALL)).eval()
    port.load_state_dict(gradtts_from_flax(params))
    cfgs = {dt: jax_gt.GradTTSConfig(**SMALL, dtype=dt) for dt in (jnp.bfloat16, None)}

    enc = {dt: jax_gt.TextEncoder(c).apply({"params": params["params"]["encoder"]}, x, xl)
           for dt, c in cfgs.items()}
    with torch.no_grad(), compute_dtype(torch.bfloat16):
        mu_x, logw, _ = port.encoder(torch.as_tensor(x), torch.as_tensor(xl))
    for i, (name, got) in enumerate((("mu_x", mu_x), ("logw", logw))):
        yardstick(f"Grad-TTS encoder {name}", got.float().numpy(),
                  np.asarray(enc[jnp.bfloat16][i], np.float32), np.asarray(enc[None][i]))

    # the sampler from the f32 synthesis's prior and lengths (the port's,
    # which test_torch_gradtts.py holds to JAX's golden)
    mu_y, _, _, ylen = port(torch.as_tensor(x), torch.as_tensor(xl), 2, max_mel_len=32,
                            noise=torch.as_tensor(noise))
    mu = mu_y.numpy().transpose(0, 2, 1)
    mask = np.arange(32)[None] < ylen.numpy()[:, None]
    z = mu + noise
    dec = {dt: jax_gt.Diffusion(c).apply({"params": params["params"]["decoder"]}, z, mask, mu,
                                         2, method=jax_gt.Diffusion.reverse_diffusion)
           for dt, c in cfgs.items()}
    with compute_dtype(torch.bfloat16):
        got = port.decoder.reverse_diffusion(*(torch.as_tensor(a) for a in (z, mask, mu)), 2)
    assert got.dtype == torch.float32  # the sampler's state stays f32, as in JAX
    yardstick("Grad-TTS sampler", got.numpy(), np.asarray(dec[jnp.bfloat16]),
              np.asarray(dec[None]))

    want = jax_gt.GradTTS(cfgs[jnp.bfloat16]).apply(params, x, xl, 2, max_mel_len=32,
                                                    noise=noise)
    with compute_dtype(torch.bfloat16):
        got = port(torch.as_tensor(x), torch.as_tensor(xl), 2, max_mel_len=32,
                   noise=torch.as_tensor(noise))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
