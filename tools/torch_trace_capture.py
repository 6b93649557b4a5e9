#!/usr/bin/env python3
"""Trace steps of one of the port's bench cases on the card and print where
the time goes (counterpart of ``tools/trace_capture.py``).

    python tools/torch_trace_capture.py hifigan_gan --amp --out out/gan_trace
    python tools/torch_trace_breakdown.py out/gan_trace --steps 3

The cases are the JAX tool's eight, at ``bench.py``'s shapes and the port's
full-width configs with random weights from a seed:

- ``diffwave_train``: a DiffWave step (30 × 64, Adam), 16 × 62 frames;
- ``hifigan_infer``: the HiFi-GAN v1 generator on 8 × 1024 mel frames;
- ``hifigan_gan``: a v1 GAN step (generator, MPD, MSD with kernel B2, the
  mels through kernel B1), 16 × 8192 samples;
- ``tacotron2_train``: a Tacotron 2 step, 64 × 128 tokens × 512 frames;
- ``flowtron_train``: a Flowtron step, 96 × 128 tokens × 384 frames;
- ``gradtts_train``: a Grad-TTS step (MAS once), 16 × 160 tokens × 512
  frames, ``out_size`` 172;
- ``talknet_spec_train``: a TalkNet 2 spectrogram-head step, 16 × 128 tokens
  × 768 frames;
- ``fastpitch_infer``: ``FastPitch.infer`` at 8 × 128 tokens, 1024 frames.

It runs one step to warm up, then traces ``--steps`` steps through
``utils/profiling.py::trace`` (a Chrome trace, ``trace_<pid>.json``, in
``--out``) and prints ``utils/profiling.py::breakdown`` of it: the card's
busy time, the idle share, time and launches by category and by kernel, in
ms a step. ``--batch`` overrides a case's batch (the JAX tool's AR-case
override), ``--amp`` computes in bf16 as the CLIs' ``--amp`` does; the
default is f32 with TF32 off. JAX's ``--unroll`` has no counterpart: the
port's autoregressive loops are Python loops and cuDNN calls, with no scan
to unroll.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CASES = ("diffwave_train", "hifigan_infer", "hifigan_gan", "tacotron2_train", "flowtron_train",
         "gradtts_train", "talknet_spec_train", "fastpitch_infer")


def random_init_(module, seed, device):
    """Seeded random weights: N(0, 1/fan_in) matrices, unit norm scales, zero
    biases, N(0, 1) embeddings."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif p.ndim == 1:
                p.fill_(1.0)
            elif "emb" in name and p.ndim == 2:
                p.normal_(0.0, 1.0, generator=gen)
            else:
                p.normal_(0.0, float(p[0].numel()) ** -0.5, generator=gen)
    return module


def _tokens(rng, batch, t_text, n_symbols):
    return rng.integers(1, n_symbols, (batch, t_text)).astype(np.int32)


def build(case: str, device, batch=None, amp: bool = False):
    """``(step, label)``: a function that runs one step of ``case`` on
    ``device``, and what it runs."""
    import torch

    from neuraltexttospeech_torch.train.harness import Trainer, TrainerConfig
    from neuraltexttospeech_torch.train.state import OptimizerConfig

    dtype = torch.bfloat16 if amp else None
    rng = np.random.default_rng(0)
    torch.manual_seed(0)

    def on(arrays):
        return {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}

    if case == "diffwave_train":
        from neuraltexttospeech_torch.cli.diffwave_train import make_loss_fn
        from neuraltexttospeech_torch.models.diffwave import DiffWave, DiffWaveConfig

        cfg = DiffWaveConfig()
        B, F = batch or 16, cfg.crop_mel_frames
        trainer = Trainer(make_loss_fn(False), DiffWave(cfg),
                          TrainerConfig(optimizer=OptimizerConfig(learning_rate=2e-4)), device,
                          dtype=dtype)
        data = on({"audio": (rng.standard_normal((B, F * cfg.hop_length, 1)) * 0.1)
                   .astype(np.float32),
                   "mel": rng.standard_normal((B, F, cfg.n_mels)).astype(np.float32)})
        return (lambda: trainer.train_step(data)), f"DiffWave train step, {B} x {F} frames"

    if case in ("hifigan_infer", "hifigan_gan"):
        from neuraltexttospeech_torch.models.hifigan import Generator, HiFiGANConfig

        cfg = HiFiGANConfig.v1()
        if case == "hifigan_infer":
            from neuraltexttospeech_torch.cli.hifigan_infer import vocode

            B, F = batch or 8, 1024
            gen = random_init_(Generator(cfg).to(device).eval(), 1, device)
            mel = torch.as_tensor(rng.standard_normal((B, F, cfg.num_mels)).astype(np.float32),
                                  device=device)
            return (lambda: vocode(gen, mel, dtype)), f"HiFi-GAN v1 generator, {B} x {F} frames"
        from neuraltexttospeech_torch.models.hifigan_gan import HiFiGANTrainer

        B = batch or 16
        trainer = HiFiGANTrainer(cfg, device, dtype=dtype)
        data = on({"audio": (rng.standard_normal((B, cfg.segment_size, 1)) * 0.1)
                   .astype(np.float32)})
        return (lambda: trainer.train_step(data)), \
            f"HiFi-GAN v1 GAN step, {B} x {cfg.segment_size} samples"

    if case == "tacotron2_train":
        from neuraltexttospeech_torch.models.tacotron2 import Tacotron2, Tacotron2Config
        from neuraltexttospeech_torch.models.tacotron2_train import loss_fn, optimizer_config

        B, T, M = batch or 64, 128, 512
        cfg = Tacotron2Config(dtype=dtype)
        trainer = Trainer(loss_fn, Tacotron2(cfg), TrainerConfig(optimizer=optimizer_config()),
                          device)
        data = on({"text": _tokens(rng, B, T, cfg.n_symbols),
                   "input_lens": np.full(B, T, np.int32),
                   "mel": rng.standard_normal((B, M, cfg.n_mel_channels)).astype(np.float32),
                   "mel_lens": np.full(B, M, np.int32)})
        return (lambda: trainer.train_step(data)), \
            f"Tacotron 2 train step, {B} x {T} tokens x {M} frames"

    if case == "flowtron_train":
        from neuraltexttospeech_torch.cli.flowtron_train import make_loss_fn
        from neuraltexttospeech_torch.models.flowtron import Flowtron, FlowtronConfig

        B, T, M = batch or 96, 128, 384
        cfg = FlowtronConfig(dtype=dtype)
        opt = OptimizerConfig(learning_rate=1e-4, grad_clip_norm=1.0, beta2=0.999, eps=1e-8)
        trainer = Trainer(make_loss_fn(), Flowtron(cfg), TrainerConfig(optimizer=opt), device)
        data = on({"text": _tokens(rng, B, T, cfg.n_text),
                   "input_lens": np.full(B, T, np.int32),
                   "mel": rng.standard_normal((B, M, cfg.n_mel_channels)).astype(np.float32),
                   "mel_lens": np.full(B, M, np.int32), "speaker": np.zeros(B, np.int32)})
        return (lambda: trainer.train_step(data)), \
            f"Flowtron train step, {B} x {T} tokens x {M} frames"

    if case == "gradtts_train":
        from neuraltexttospeech_torch.cli.gradtts_train import make_loss_fn
        from neuraltexttospeech_torch.models.gradtts import GradTTS, GradTTSConfig

        B, T, M = batch or 16, 160, 512
        cfg = GradTTSConfig()
        model = random_init_(GradTTS(cfg).to(device), 31, device)
        with torch.no_grad():  # ~3.2 frames a token; ReZero gains small, as trained ones start
            model.encoder.proj_w.proj.bias.fill_(float(np.log(3.2)))
            for name, p in model.named_parameters():
                if name.endswith(".g"):
                    p.fill_(0.02)
        opt = OptimizerConfig(learning_rate=1e-4, grad_clip_norm=1.0)
        trainer = Trainer(make_loss_fn(cfg.out_size), model, TrainerConfig(optimizer=opt), device,
                          dtype=dtype)
        text = np.full((B, T), cfg.n_symbols - 1, np.int32)  # interspersed with the blank
        text[:, 1::2] = rng.integers(1, cfg.n_symbols - 1, (B, T // 2))
        data = on({"text": text, "input_lens": np.full(B, T, np.int32),
                   "mel": rng.standard_normal((B, M, cfg.n_feats)).astype(np.float32),
                   "mel_lens": np.full(B, M, np.int32)})
        return (lambda: trainer.train_step(data)), \
            f"Grad-TTS train step, {B} x {T} tokens x {M} frames, out_size {cfg.out_size}"

    if case == "talknet_spec_train":
        from neuraltexttospeech_torch.cli.talknet_train import HEADS, LOSSES, optimizer_config
        from neuraltexttospeech_torch.models.talknet import TalkNet2Config

        B, T, M = batch or 16, 128, 768
        cfg = TalkNet2Config(dtype=dtype)
        trainer = Trainer(LOSSES["spectrogram"], HEADS["spectrogram"](cfg),
                          TrainerConfig(optimizer=optimizer_config(1e-3)), device)
        data = on({"text": _tokens(rng, B, T, cfg.n_symbols),
                   "input_lens": np.full(B, T, np.int32), "mel_lens": np.full(B, M, np.int32),
                   "dur": np.full((B, T), M // T, np.float32),
                   "mel": rng.standard_normal((B, M, cfg.n_mel_channels)).astype(np.float32),
                   "pitch": rng.standard_normal((B, T)).astype(np.float32),
                   "energy": rng.standard_normal((B, T)).astype(np.float32)})
        return (lambda: trainer.train_step(data)), \
            f"TalkNet 2 spectrogram-head train step, {B} x {T} tokens x {M} frames"

    if case == "fastpitch_infer":
        from neuraltexttospeech_torch.models.fastpitch import FastPitch, FastPitchConfig
        from neuraltexttospeech_torch.nn.precision import compute_dtype

        B, T, M = batch or 8, 128, 1024
        cfg = FastPitchConfig()
        fp = random_init_(FastPitch(cfg).to(device), 0, device).eval()
        with torch.no_grad():  # about 6 frames a token
            fp.duration_predictor.fc.bias.fill_(float(np.log(7.0)))
        text = torch.as_tensor(_tokens(rng, B, T, cfg.n_symbols), device=device)
        lens = torch.full((B,), T, dtype=torch.int32, device=device)

        def step():
            with torch.inference_mode(), compute_dtype(dtype):
                return fp.infer(text, lens, max_mel_len=M)[0]

        return step, f"FastPitch.infer, {B} x {T} tokens, max_mel_len {M}"

    raise SystemExit(f"unknown case {case!r}; the cases are {', '.join(CASES)}")


def capture(case: str, out: str, steps: int = 3, batch=None, amp: bool = False,
            device: str = "cuda"):
    """Warm ``case`` up with one step, then trace ``steps`` steps into
    ``out``: ``(Breakdown, label, wall seconds a traced step)``."""
    import torch

    from neuraltexttospeech_torch.utils.device import resolve_device
    from neuraltexttospeech_torch.utils.profiling import breakdown, trace

    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    step, label = build(case, device, batch, amp)
    step()
    sync()
    with trace(out) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        sync()
        wall = (time.perf_counter() - t0) / steps
    return breakdown(prof, steps), label, wall


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("what", choices=CASES)
    ap.add_argument("--out", default=None,
                    help="trace directory (default: out/trace_<case> in this checkout)")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=None, help="the case's batch, overridden")
    ap.add_argument("--amp", action="store_true", help="bf16 compute (default: f32, TF32 off)")
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    a = ap.parse_args(argv)
    out = a.out or str(ROOT / "out" / f"trace_{a.what}")
    b, label, wall = capture(a.what, out, a.steps, a.batch, a.amp, a.device)
    print(f"{label}, {'bf16 (--amp)' if a.amp else 'f32 (TF32 off)'}: {a.steps} traced steps, "
          f"wall {wall * 1e3:.3f} ms a step under the profiler; trace in {out}", flush=True)
    print(b.table(a.top), flush=True)
    return b


if __name__ == "__main__":
    main()
