#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``neuraltexttospeech_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of the repository

Phases, each raising on failure:

1. Device: the card's name and power limit.
2. Kernels: build the three kernels from ``ops/csrc`` (one ``nvcc`` each,
   at once), run their ``gpu``-marked tests (``tests/test_torch_kernels.py``,
   in a pytest subprocess), hold each against its plain PyTorch twin on the
   card (TF32 off)
   and time the kernel, the twin and the PyTorch library call for the same
   function, by device time (the profiler's kernel time) and by CUDA events
   over back-to-back calls (which include the host's dispatch): B1 (log-mel)
   forward at the serving, GAN-training and DiffWave-dataset shapes (the
   last with the dataset's mel and loss-mel configs) and its analytic
   backward; B2 (the MSD's tap-window grouped GEMM)
   at every distinct MSD shape of a v1 GAN step, forward and dx, in its f32
   (3xTF32) and its bf16 form, each beside grouped ``F.conv1d`` in the same
   type, with an ``HGMMA`` check of both forms' SASS and each shape's A
   bytes moved into shared memory; MAS (monotonic alignment search, bit for
   bit) at 16 × 768 × 128 and 16 × 870 × 192, and at the Grad-TTS step's
   16 × 512 × 160 on Grad-TTS's Gaussian log-prior, with the kernel's own
   split into forward, backtrack and plane write (time stamps).
3. Serving path, through the two serving CLIs with full-width FastPitch and
   HiFi-GAN v1 (random weights from a seed), f32 and then ``--amp`` (bf16):
   text → wav for 16 sentences, then wav → wav copy-synthesis, whose
   log-mels go through B1.
4. Training path, through the trainer CLI at v1 (batch 16 × 8192 samples),
   f32 and then ``--amp``: 2 steps, then ``--resume`` for one more; finite
   losses, f32 parameters, and B1 and B2 launched as often per step as the
   code says (under ``--amp`` every B2 launch in its bf16 form). Then one
   step on ``--fine-tuning-mel-dir`` (mels written from the wavs' own
   log-mels). For each path the launch counts are zeroed just before and
   read just after.
5. FastPitch training path: 16 synthetic wavs with the ``SENTENCES`` texts
   through the dataset-prep CLI on the card (B1 once per wav), then the
   FastPitch trainer CLI at full width (batch 16), f32 and then ``--amp``:
   2 steps, then ``--resume`` for one more; finite losses, MAS launched once
   per step, and the serving CLI's loader gives the trainer's model.
6. DiffWave path: ``diffwave_train`` at full width (30 layers × 64
   channels, batch 16 × 62 frames, validation on), f32 and ``--amp``, 2
   steps then ``--resume`` for a 3rd, the dataset's mels through B1 on the
   card (twice a batch, checked; one batch against the host's mels);
   ``diffwave_infer --fast`` whole,
   ``--chunked`` and ``--amp`` on the trained checkpoint. Grad-TTS serving:
   the 16 sentences through ``gradtts_infer`` with a full-width Grad-TTS
   and HiFi-GAN v1, batch 8, f32 and ``--amp``. Grad-TTS training:
   ``gradtts_train`` at full width on the FastPitch phase's 16 wavs (batch
   16, validation on, 2 steps then ``--resume`` for a 3rd, f32 and
   ``--amp``; MAS once a step and once a validation batch), then
   ``gradtts_infer`` from the trained checkpoint. FastSpeech 2: synthetic
   TextGrids for the same wavs through ``fastspeech2_prepare_dataset`` on
   the card (B1 once a wav; each log-mel held against the host's and B1's
   twin), ``fastspeech2_train`` at full width (f32 and ``--amp``, 2 steps
   then ``--resume``) and ``fastspeech2_infer`` with the v1 vocoder.
   TalkNet 2: ``talknet_train --model asr`` (QuartzNet 5×5) on the same 16
   wavs and their ``SENTENCES`` transcripts, batch 16, 2 steps then
   ``--resume`` for a 3rd, the dataset's log-mels through B1 on the card
   (once an utterance an epoch, counted, and held against its twin); the
   duration, pitch and spectrogram heads on FastSpeech 2's prepared corpus,
   f32 and ``--amp``, 2 steps then ``--resume``; ``talknet_infer`` of the 16
   sentences with the v1 vocoder, f32 and ``--amp``. Tacotron 2: the same
   16 wavs through ``tacotron2_prepare_dataset`` on the card (B1 once a wav,
   counted, each log-mel held against the host's and B1 against its twin),
   ``tacotron2_train`` at ``Tacotron2Config()`` (batch 16, 2 steps then
   ``--resume`` for a 3rd, f32 and ``--amp``), ``tacotron2_infer`` of the 16
   sentences (1000 decoder steps) with the v1 vocoder, f32 and ``--amp``.
   Flowtron: the same wavs through ``tacotron2_prepare_dataset`` again
   (Flowtron's features; B1 once a wav, counted), ``flowtron_train`` at
   ``FlowtronConfig()`` (batch 16, validation on, 2 steps then ``--resume``
   for a 3rd, f32 and ``--amp``), ``flowtron_infer`` of the 16 sentences
   (400 frames) with the v1 vocoder, f32 and ``--amp``. The data tools:
   ``dump_mels`` on the FastPitch and Tacotron 2 runs (MAS once a batch on
   FastPitch's, counted), one ``hifigan_train --fine-tuning-mel-dir`` step
   on FastPitch's dumped mels, ``align_from_fastpitch`` (MAS once a batch)
   and one ``fastspeech2_train`` step on its output, ``export`` of the
   FastPitch run reloaded and compared.
7. Reference checks: at a small width the card's text → wav and
   copy-synthesis agree with the same weights on the CPU, and so do one
   GAN step of the small (``TINY``) generator with the full MPD and MSD,
   one FastPitch train step of the golden's small FastPitch (dropout off),
   one small DiffWave train step and 6-step sample, a small Grad-TTS
   synthesis, one small Grad-TTS and one small FastSpeech 2 train step
   (the Grad-TTS step's MAS paths equal on both devices), and one step of a
   small QuartzNet ASR and of each small TalkNet 2 head (their BatchNorm
   buffers too), each in f32 and in bf16 (not the ASR, whose ``--amp`` is
   ignored) (bf16 by the yardstick of
   tests/test_torch_bf16.py with the CPU's f32 run in the place of JAX's);
   a small Tacotron 2's forwards (the card's cuDNN BiLSTM against the CPU's
   loop), one train step (its BatchNorm buffers, and bf16) and ``infer`` in
   both forms; a small Flowtron's density pass (its LSTMs through cuDNN on
   the card, the loop on the CPU) and ``infer``, one train step and its
   bf16 step.
8. Timing: text → wav at the ``bench.py`` shape (batch 8 × 128 tokens,
   1024 mel frames), f32 and bf16, in wall seconds per audio second; the v1
   GAN step in ms and samples/s, the FastPitch train step at the
   ``bench.py`` shape (16 × 128 tokens × 768 frames) in ms and mel frames/s,
   the DiffWave train step at its ``bench.py`` shape (16 × 62 frames) and
   its 6-step sampler at 1 × 256 frames (and the 50-step one once),
   Grad-TTS → HiFi-GAN v1 (8 × 128 tokens, 10 steps, 1000 frames), the
   Grad-TTS train step (16 × 160 tokens × 512 frames, ``out_size`` 172,
   with MAS's share) and the FastSpeech 2 train step (16 × 128 tokens × 768
   frames), each f32 and bf16 with a profiler split, idle share and launch
   count; TalkNet 2 at full width: the spectrogram head's step at 16 × 128
   tokens × 768 frames (f32 and ``--amp``), the duration and pitch heads'
   steps, the ASR step at 16 × 768 frames with 160 labels, and text → wav
   through the three heads and v1 at 8 × 128 tokens (f32 and ``--amp``);
   Tacotron 2 at full width: the train step at 64 × 128 tokens × 512 frames
   and text → wav through 1000 decoder steps and v1 at 8 × 128 tokens, each
   f32 and ``--amp``; Flowtron at full width: the train step at 96 × 128
   tokens × 384 frames and noise → mel → wav through 2 flows × 1000 frames
   and v1 at 8 × 128 tokens, each f32 and ``--amp``.

9. Parallelism (``parallel/``): NCCL at world size 1 joined in this
   process, the full-width FastPitch ``Trainer`` step (ragged lengths,
   dropout on; MAS ×1) and the v1 GAN step (B1 ×3, B2 ×90) on a one-rank
   data-parallel mesh held to the plain one-card step (metrics rtol 2e-5,
   parameters atol 3e-5) and timed beside it, with the GAN step's idle
   share; two gloo processes with both ranks on the card
   (``tools/torch_parallel_check.py``): DP = 2 FastPitch, TalkNet 2
   (BatchNorm) and GAN steps and TP = 2 FastPitch held to the one-process
   step, with each rank's B1, B2 and MAS launches; the host-fed FastPitch
   CLI loop (``tools/torch_cli_throughput.py``, 2 epochs × 8 steps).
10. Serving over several devices (``utils/serving.py``): the six text →
   mel serving loops with HiFi-GAN v1 at full width on 8 sentences, on
   ``[cuda:0]`` and on ``[cuda:0, cuda:0]`` (two replicas, two host
   threads), held to each other, FastPitch also with ``--amp``; the trace
   tools (``tools/torch_trace_capture.py``, ``tools/torch_trace_breakdown.py``)
   on the bf16 GAN step (B2 bf16 ×90, B1 ×3) and FastPitch inference; and
   ``tools/torch_audio_compare.py`` on a 10 s wav, B1 on the card.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result.
"""

import json
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
WORK = ROOT / "out" / "chip_smoke"
SR, HOP = 22050, 256
SENTENCES = [
    "The quick brown fox jumps over the lazy dog.",
    "Printing, in the only sense with which we are at present concerned.",
    "It was the best of times, it was the worst of times.",
    "Dr. Smith paid $12.50 for 3 apples on Jan. 5th, 2021.",
    "How much wood would a woodchuck chuck?",
    "She sells sea shells by the sea shore.",
    "The train leaves at 7:45 in the morning.",
    "A journey of a thousand miles begins with a single step.",
    "Hello world.",
    "Speech synthesis turns written text into audible speech.",
    "In 1865, the war ended and reconstruction began.",
    "Please call me back at your earliest convenience.",
    "Mr. and Mrs. Jones arrived at 10 p.m. yesterday.",
    "The rain in Spain stays mainly in the plain.",
    "Neural vocoders generate waveforms one sample block at a time.",
    "Numbers like 1,234,567 are read out in full.",
]


def log(msg):
    print(msg, flush=True)


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


def random_fastpitch(cfg, seed, device):
    """Random FastPitch whose duration head starts near 6 frames per token
    (log(1 + 6)), so the utterances have speech-like lengths."""
    import torch
    from neuraltexttospeech_torch.models.fastpitch import FastPitch

    fp = random_init_(FastPitch(cfg).to(device), seed, device)
    with torch.no_grad():
        fp.duration_predictor.fc.bias.fill_(float(np.log(7.0)))
    return fp.eval()


def cuda_ms(fn, iters):
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, reps=10):
    """Device time of one call of ``fn`` (ms): the card's busy time over a
    trace of ``reps`` calls (:func:`device_breakdown`; for kernels that run
    one after another, the sum of their ``self_device_time_total``), per
    call. Unlike :func:`cuda_ms` it leaves out the host's dispatch between
    kernels."""
    fn()
    torch.cuda.synchronize()
    # Now and then a trace comes back without the card's records (seen a few
    # times in a few hundred traces, twice in a row at most): trace again.
    for attempt in range(6):
        busy, _ = device_breakdown(torch, lambda: [fn() for _ in range(reps)])
        if busy > 0:
            return busy / reps
        log(f"  device_ms: trace {attempt + 1} holds no device time; host runtime calls "
            f"{device_breakdown.runtime}")
        time.sleep(0.2)
    raise RuntimeError("the profiler recorded no device time for a call that launches kernels")


def synthetic_wavs(n, seconds, seed):
    """Sines plus noise, [n, seconds·SR] float32 in (-1, 1)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    out = np.zeros((n, t.size), np.float32)
    for i in range(n):
        for _ in range(4):
            f, a, ph = rng.uniform(80, 4000), rng.uniform(0.05, 0.2), rng.uniform(0, 2 * np.pi)
            out[i] += (a * np.sin(2 * np.pi * f * t + ph)).astype(np.float32)
        out[i] += 0.01 * rng.standard_normal(t.size).astype(np.float32)
    return out


def logmel_bound_ms(n, cfg):
    """Least time an H100 could take to turn ``n`` windowed frames into
    log-mels (NVIDIA's SXM peaks: 67 TFLOP/s f32 outside the tensor cores,
    3.35 TB/s HBM), the larger of operations and bytes over their peaks.

    Counts the work the function needs: an rFFT (2.5·n_fft·log2 n_fft FLOP a
    frame), |X|² and its root (4 a bin), the mel projection over the basis's
    nonzeros (2 each), clip and log (2 a mel); bytes are the frames read,
    the log-mels written and the basis's nonzeros read, each once. Returns
    ``(bound_ms, bound_by, dft_bound_ms)``, the last the same bound for the
    DFT-as-matmul form the kernel computes (dense cos/sin products and mel
    projection, its constants read once).
    """
    n_fft, n_mels = cfg.filter_length, cfg.n_mel_channels
    n_bins = n_fft // 2 + 1
    nnz = int(np.count_nonzero(cfg.mel_basis()))
    flop = n * (2.5 * n_fft * np.log2(n_fft) + 4 * n_bins + 2 * nnz + 2 * n_mels)
    nbytes = 4 * (n * n_fft + n * n_mels + nnz)
    t_ops, t_bytes = flop / 67e12, nbytes / 3.35e12
    dft_flop = n * (2 * n_fft * n_bins * 2 + 2 * n_bins * n_mels)
    dft_bytes = 4 * (n * n_fft + n * n_mels + 2 * n_fft * n_bins + n_bins * n_mels)
    dft_bound_ms = max(dft_flop / 67e12, dft_bytes / 3.35e12) * 1e3
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes",
            dft_bound_ms)


def build_kernels():
    """Build every kernel's library at once, one ``nvcc`` per source."""
    from concurrent.futures import ThreadPoolExecutor

    from neuraltexttospeech_torch.ops import _build, gouter_kernel, mas_kernel, mel_kernel

    t0 = time.perf_counter()
    sources = (mel_kernel.SOURCE, gouter_kernel.SOURCE, mas_kernel.SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(_build.load, sources)))
    log(f"kernels built: {', '.join(sources)} ({time.perf_counter() - t0:.1f} s)")
    sass = subprocess.run([_build.tool("cuobjdump"), "-sass", libs[gouter_kernel.SOURCE]._name],
                          capture_output=True, text=True, check=True).stdout
    # HGMMA (wgmma) instructions in each form's main kernel: the f32 form
    # (tap_dots_tc_kernel<Tf32x3>, .tf32 operands) and the bf16 form
    # (window_taps_bf16_kernel, .bf16 operands)
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif "HGMMA" in line and fn:
            counts[fn] = counts.get(fn, 0) + 1
    for form, kernel in (("f32", B2_MAIN_KERNELS[0]), ("bf16", B2_MAIN_KERNELS[1])):
        n = sum(c for name, c in counts.items() if kernel in name)
        log(f"B2's {form} kernel ({kernel}) holds {n} HGMMA (wgmma) instructions in its SASS")
        if not n:
            raise RuntimeError(f"B2's {form} form was compiled without wgmma: no HGMMA")


def phase_gpu_tests():
    """The ``gpu``-marked tests on the card: the kernels' (``tests/test_torch_kernels.py``:
    each kernel against its twin at the main path's shapes and at its edges)
    and serving's (``tests/test_torch_serving.py``: no ``--device`` means every
    visible card)."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "pytest",
                          str(ROOT / "tests" / "test_torch_kernels.py"),
                          str(ROOT / "tests" / "test_torch_serving.py"),
                          "--noconftest", "-m", "gpu", "-q", "-p", "no:cacheprovider"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    lines = out.stdout.strip().splitlines()
    log(f"gpu tests of the kernels: {lines[-1] if lines else ''} "
        f"({time.perf_counter() - t0:.1f} s)")
    if out.returncode != 0:
        log(out.stdout[-6000:] + out.stderr[-2000:])
        raise RuntimeError(f"the kernels' gpu tests failed (pytest exit {out.returncode})")


def phase_kernels(torch, device, card):
    """B1: hold against the plain twin, time. Returns the JSON record."""
    from neuraltexttospeech_torch.audio.stft import STFTConfig, num_frames, windowed_frames
    from neuraltexttospeech_torch.ops import mel_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tol = dict(atol=1e-3, rtol=1e-4)  # tests/test_audio.py's log-mel budget
    pad = (1024 - HOP) // 2
    wavs = torch.as_tensor(synthetic_wavs(16, 10.0, seed=0), device=device)
    # the serving path's call: one reflect-padded 10 s wav (copy-synthesis);
    # the GAN training path's: 16 reflect-padded 8192-sample crops (512
    # frames); the DiffWave dataset's: 16 reflect-padded 62-frame crops (992
    # frames), with its two configs, the mel's (fmax 8 kHz) and the loss
    # mel's (fmax_for_loss unset: sr / 2)
    one = torch.nn.functional.pad(wavs[:1, None], (pad, pad), mode="reflect")[0, 0]
    crops = torch.nn.functional.pad(wavs[:, None, :8192], (pad, pad), mode="reflect")[:, 0]
    dw_crops = torch.nn.functional.pad(wavs[:, None, :62 * HOP], (pad, pad),
                                       mode="reflect")[:, 0]
    powers = {f"p={p}": STFTConfig(magnitude_power=p) for p in (0.5, 2.0)}
    shapes = {"one_wav": (one, powers), "train_16x8192": (crops, powers),
              "batch_8x10s": (wavs[:8], powers),
              "diffwave_16x62": (dw_crops, {"mel": STFTConfig(mel_fmax=8000.0),
                                            "loss mel": STFTConfig(mel_fmax=SR / 2.0)})}
    record = None
    for label, (x, configs) in shapes.items():
        frames = windowed_frames(x, 1024, HOP, 1024).reshape(-1, 1024).contiguous()
        n = frames.shape[0]
        assert n == x.numel() // x.shape[-1] * num_frames(x.shape[-1], 1024, HOP)
        err = 0.0
        for name, cfg in configs.items():
            got = mel_kernel.fused_frames_to_mel(frames, cfg)
            want = mel_kernel.frames_to_mel_reference(frames, cfg)
            torch.cuda.synchronize()
            d = (got - want).abs().max().item()
            log(f"B1 {label} N={n} {name}: max|kernel - plain| = {d:.3e}")
            torch.testing.assert_close(got, want, **tol)
            err = max(err, d)
        cfg = STFTConfig()
        window = torch.hann_window(1024, periodic=True, device=device)
        basis = torch.as_tensor(cfg.mel_basis(), device=device)

        def library():
            spec = torch.stft(x, 1024, HOP, 1024, window, center=False,
                              return_complex=True).abs()
            mel = torch.matmul(spec.pow(0.5).transpose(-1, -2), basis)
            return torch.log(torch.clamp(mel, min=1e-5))

        lib_out = library().reshape(-1, 80)
        torch.testing.assert_close(lib_out, mel_kernel.frames_to_mel_reference(frames, cfg),
                                   **tol)
        fns = {"kernel": lambda: mel_kernel.fused_frames_to_mel(frames, cfg),
               "plain": lambda: mel_kernel.frames_to_mel_reference(frames, cfg),
               "library": library}
        iters = 20 if n < 2000 else 10
        ev = {k: cuda_ms(fn, iters) for k, fn in fns.items()}  # back-to-back calls
        dev = {k: device_ms(torch, fn) for k, fn in fns.items()}  # kernels only
        bound_ms, bound_by, dft_bound_ms = logmel_bound_ms(n, cfg)
        log(f"B1 {label} N={n}: device time kernel {dev['kernel'] * 1e3:.2f} us, plain "
            f"{dev['plain'] * 1e3:.2f} us, torch.stft path {dev['library'] * 1e3:.2f} us; "
            f"CUDA events over back-to-back calls kernel {ev['kernel'] * 1e3:.2f} us, plain "
            f"{ev['plain'] * 1e3:.2f} us, torch.stft path {ev['library'] * 1e3:.2f} us; "
            f"bound {bound_ms * 1e3:.2f} us ({bound_by}; rFFT + sparse mel), "
            f"{bound_ms / dev['kernel']:.1%} of it reached by device time; bound of the "
            f"DFT-matmul form {dft_bound_ms * 1e3:.1f} us [{card}]")
        if label == "one_wav":
            record = {"name": "mel_kernel.fused_frames_to_mel", "route": "cuda",
                      "source": "neuraltexttospeech_torch/ops/csrc/mel_kernel.cu",
                      "replaces": "neuraltexttospeech_tpu/ops/mel_kernel.py:163",
                      "launches": None, "max_abs_err": err, "ms": dev["kernel"],
                      "plain_ms": dev["plain"], "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": dev["library"]}
        if label == "train_16x8192":
            check_mel_backward(torch, frames, cfg, card)
    return record


def check_mel_backward(torch, frames, cfg, card):
    """B1's analytic backward (the mel loss's gradient) against autograd
    through the plain twin; both timed, forward included."""
    from neuraltexttospeech_torch.ops import mel_kernel

    g = torch.randn(frames.shape[0], cfg.n_mel_channels, device=frames.device)
    grads = {}
    for name, fn in (("kernel", mel_kernel.fused_frames_to_mel),
                     ("plain", mel_kernel.frames_to_mel_reference)):
        f = frames.clone().requires_grad_()
        out = fn(f, cfg)
        if out.grad_fn is None:
            raise RuntimeError(f"the {name} log-mel carries no gradient")
        out.backward(g)
        grads[name] = f.grad
    scale = grads["plain"].abs().max().item()
    d = (grads["kernel"] - grads["plain"]).abs().max().item()
    log(f"B1 backward N={frames.shape[0]}: max|analytic - autograd through plain| = "
        f"{d:.3e} ({d / scale:.2e} of max|grad|)")
    if d > 1e-4 * scale:  # tests/test_audio.py's VJP budget
        raise RuntimeError("B1's backward disagrees with autograd through its twin")
    ms = {}
    for name, fn in (("kernel", mel_kernel.fused_frames_to_mel),
                     ("plain", mel_kernel.frames_to_mel_reference)):
        f = frames.clone().requires_grad_()
        ms[name] = cuda_ms(lambda: fn(f, cfg).backward(g), 10)
    bwd_ms = cuda_ms(lambda: mel_kernel.frames_to_mel_backward(frames, g, cfg), 10)
    log(f"B1 forward+backward N={frames.shape[0]}: kernel + analytic {ms['kernel'] * 1e3:.1f} us "
        f"(backward alone {bwd_ms * 1e3:.1f} us), plain + autograd {ms['plain'] * 1e3:.1f} us "
        f"[{card}]")


def msd_tap_shapes(batch, length):
    """Every B2 call of one MSD pass over ``batch`` wavs of ``length``
    samples, as ``(scale, layer, forward (g, B, Qp, X, Y, kf, s, q), dx
    shape)``, from the model's own layer plan and fold plan."""
    from neuraltexttospeech_torch.models.hifigan import DiscriminatorS
    from neuraltexttospeech_torch.nn.fastconv import plan_folded

    d = DiscriminatorS(group_impl="gouter")
    shapes = []
    for scale in range(3):
        cin = 1
        for layer, ((ch, k, st, g), use, n) in enumerate(d.layer_plan(length)):
            if use:
                pi, po = use
                _, m_min, m_max, s = plan_folded(k, st, 1, pi, po)
                kf = (m_max - m_min) // s + 1
                q = n // pi
                qp = q + m_max - m_min
                x_dim, y_dim = pi * cin // g, po * ch // g
                fwd = (g, batch, qp, x_dim, y_dim, kf, s, q)
                dx = (g, batch, qp + (kf - 1) * s, y_dim, x_dim, kf, s, qp)
                shapes.append((scale, layer, fwd, dx))
            cin = ch
        length = -(-length // 2)  # the SAME 4-tap, stride-2 average pool
    return shapes


def tap_dots_bound_ms(shape, dtype="f32"):
    """Least time an H100 could take for one tap-window call (NVIDIA's SXM
    peaks): the larger of 2*g*B*kf*q*X*Y FLOP at the operands' tensor-core
    rate and the bytes of xp, wf and y, each once, at 3.35 TB/s. f32 is
    f32-accurate, so 495/3 TFLOP/s (the TF32 tensor cores' dense rate, three
    products per f32 product) and 4 bytes a value; bf16 is 989 TFLOP/s
    dense and 2 bytes a value. Returns ``(bound_ms, bound_by, t_ops_ms,
    t_bytes_ms, fma_bound_ms)``, the last the same bound for f32 FMAs on the
    CUDA cores (67 TFLOP/s)."""
    g, b, qp, x_dim, y_dim, kf, s, q = shape
    flop = 2 * g * b * kf * q * x_dim * y_dim
    rate, size = (989e12, 2) if dtype == "bf16" else (495e12 / 3, 4)
    nbytes = size * (g * b * qp * x_dim + kf * g * x_dim * y_dim + g * b * q * y_dim)
    t_ops, t_bytes = flop / rate * 1e3, nbytes / 3.35e12 * 1e3
    fma_ms = max(flop / 67e12 * 1e3, t_bytes)
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", t_ops, t_bytes,
            fma_ms)


# kernel names of B2 in a profile: its main kernel in the f32 and the bf16
# form, its prologue and its split-K sum
B2_MAIN_KERNELS = ("tap_dots_tc_kernel", "window_taps_bf16_kernel")
B2_KERNELS = B2_MAIN_KERNELS + ("pack_weights_kernel", "sum_splits_kernel")


def gathered_a_bytes(shape, plan_f32_ring, plan_window=None):
    """Bytes of A that one B2 call moves into shared memory: the f32 form's
    ring (which the bf16 form also ran before its window kernel) gathers
    each tile's rows once per tap and K block; the window kernel loads each
    tile's window once per unit
    (64 values of X by a group of taps). ``plan_f32_ring`` is
    ``(warpgroups, columns, splits)``, ``plan_window`` the window kernel's
    ``(64-row tiles, taps, splits)`` (128 columns). Returns ``(ring,
    window)``, the latter None without a window plan."""
    from neuraltexttospeech_torch.ops import gouter_kernel

    g, b, qp, x_dim, y_dim, kf, s, q = shape
    m = b * q
    nwg, bn, _ = plan_f32_ring
    ring = -(-m // (64 * nwg)) * 64 * nwg * (y_dim // bn) * g * kf * x_dim * 2
    if plan_window is None:
        return ring, None
    tiles, taps, _ = plan_window
    rows = 0
    for m0 in range(0, m, 64 * tiles):
        for mf0 in range(0, kf, taps):
            segs = gouter_kernel.window_segments(m0, min(m0 + 64 * tiles, m), q, qp, mf0,
                                                 min(taps, kf - mf0), s)
            rows += sum(n for _, _, n in segs)
    return ring, rows * 128 * (x_dim // 64) * (y_dim // 128) * g


def excess_over_one_bf16_ulp(got, want):
    """tests/test_torch_kernels.py's bf16 tolerance: the largest excess of
    |got - want| over one bf16 ulp of want plus 1e-5 of max|want| (<= 0: all
    within)."""
    got, want = got.double(), want.double()
    ulp = (want.abs().clamp_min(1e-30).log2().floor() - 7).exp2()
    return ((got - want).abs() - ulp - 1e-5 * want.abs().max()).max().item()


def phase_tap_dots(torch, device, card, dtype="f32"):
    """B2 at every distinct MSD shape of a v1 GAN step (batch 16 × 8192),
    forward and dx (the dx form: weights flipped and transposed in the
    kernel, ``flip_t``), in its f32 or bf16 form: held against the twin
    (f32: rtol 1e-5, atol 1e-5·max|y|; bf16: within one bf16 ulp), timed
    beside the twin, grouped F.conv1d in the same type and the bound.
    Returns the JSON record (sums over the distinct shapes)."""
    from neuraltexttospeech_torch.ops import gouter_kernel

    F = torch.nn.functional
    bf16 = dtype == "bf16"
    gen = torch.Generator(device=device).manual_seed(0)
    keys = ("ms", "plain_ms", "library_ms", "ev_ms", "ev_plain_ms", "ev_library_ms",
            "bound_ms", "t_ops", "t_bytes", "fma_bound_ms")
    totals = dict.fromkeys(keys + ("a_ring", "a_window"), 0.0)
    worst = worst_excess = 0.0
    for scale, layer, fwd, dx in msd_tap_shapes(16, 8192):
        for kind, shape, flip_t in (("fwd", fwd, False), ("dx", dx, True)):
            g, b, qp, x_dim, y_dim, kf, s, q = shape
            xp = torch.randn(g, b, qp, x_dim, device=device, generator=gen)
            w_shape = (kf, g, y_dim, x_dim) if flip_t else (kf, g, x_dim, y_dim)
            wf = torch.randn(*w_shape, device=device, generator=gen) / (kf * x_dim) ** 0.5
            if bf16:
                xp, wf = xp.bfloat16(), wf.bfloat16()
            got = gouter_kernel.gouter_tap_dots_kernel(xp, wf, s, q, flip_t)
            want = gouter_kernel.gouter_tap_dots_reference(xp, wf, s, q, flip_t)
            torch.cuda.synchronize()
            if got.dtype != xp.dtype:
                raise RuntimeError(f"B2 returned {got.dtype} for {xp.dtype} operands")
            d = (got.float() - want.float()).abs().max().item()
            scale_y = want.float().abs().max().item()
            if bf16:
                excess = excess_over_one_bf16_ulp(got, want)
                worst_excess = max(worst_excess, excess)
                if excess > 0:
                    raise RuntimeError(f"B2 bf16 {kind} {shape}: more than one bf16 ulp from "
                                       f"its twin (by {excess:.3e})")
            else:
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale_y)
            worst = max(worst, d)
            # the library call: grouped, dilated conv1d over [B, g*X, Qp]
            w_eff = torch.flip(wf, (0,)).transpose(-1, -2) if flip_t else wf
            x_lib = xp.permute(1, 0, 3, 2).reshape(b, g * x_dim, qp).contiguous()
            w_lib = w_eff.permute(1, 3, 2, 0).reshape(g * y_dim, x_dim, kf).contiguous()
            lib = F.conv1d(x_lib, w_lib, dilation=s, groups=g)
            lib_tol = 2.0 ** -6 if bf16 else 1e-4  # cuDNN's own sums
            torch.testing.assert_close(lib.reshape(b, g, y_dim, q).permute(1, 0, 3, 2).float(),
                                       want.float(), rtol=lib_tol, atol=lib_tol * scale_y)
            fns = {"": lambda: gouter_kernel.gouter_tap_dots_kernel(xp, wf, s, q, flip_t),
                   "plain_": lambda: gouter_kernel.gouter_tap_dots_reference(xp, wf, s, q, flip_t),
                   "library_": lambda: F.conv1d(x_lib, w_lib, dilation=s, groups=g)}
            t = {}
            for name, fn in fns.items():
                t[f"ev_{name}ms"] = cuda_ms(fn, 5)
                t[f"{name}ms"] = device_ms(torch, fn, 3)
            t["bound_ms"], bound_by, t["t_ops"], t["t_bytes"], t["fma_bound_ms"] = \
                tap_dots_bound_ms(shape, dtype)
            flop = 2 * g * b * kf * q * x_dim * y_dim
            sms = torch.cuda.get_device_properties(device).multi_processor_count
            ring_plan = gouter_kernel.plan_tiles(g, b * q, y_dim,
                                                 kf * x_dim // gouter_kernel.k_block(xp.dtype), sms)
            if bf16:
                plan = gouter_kernel.plan_window(g, b * q, y_dim, q, kf, s, x_dim, sms)
                ring_bytes, win_bytes = gathered_a_bytes(shape, ring_plan, plan)
                tile = (f"tile {64 * plan[0]}x128, {plan[1]} taps a unit, {plan[2]} K splits; "
                        f"A moved into shared memory {win_bytes / 1e6:.2f} MB, "
                        f"{ring_bytes / 1e6:.2f} MB by the ring's gathers")
                totals["a_ring"] += ring_bytes
                totals["a_window"] += win_bytes
            else:
                tile = f"tile {64 * ring_plan[0]}x{ring_plan[1]}, {ring_plan[2]} K splits"
            log(f"B2 {dtype} scale {scale} layer {layer} {kind} (g={g}, B={b}, Qp={qp}, X={x_dim}, "
                f"Y={y_dim}, kf={kf}, s={s}, q={q}; {tile}): max|kernel - plain| {d:.3e} "
                f"({d / scale_y:.1e} of "
                f"max|y|); device time kernel {t['ms'] * 1e3:.1f} us "
                f"({flop / t['ms'] / 1e9:.1f} TFLOP/s), plain {t['plain_ms'] * 1e3:.1f} us, "
                f"grouped conv1d {t['library_ms'] * 1e3:.1f} us; "
                f"events kernel {t['ev_ms'] * 1e3:.1f} us, plain {t['ev_plain_ms'] * 1e3:.1f} us, "
                f"conv1d {t['ev_library_ms'] * 1e3:.1f} us; bound {t['bound_ms'] * 1e3:.1f} us "
                f"({bound_by}, {'bf16' if bf16 else '3xTF32'}), {t['bound_ms'] / t['ms']:.1%} of "
                f"it reached; f32-FMA bound {t['fma_bound_ms'] * 1e3:.1f} us")
            for key in keys:
                totals[key] += t[key]
            del xp, wf, got, want, x_lib, w_lib, lib
    rate = "bf16 at 989 TFLOP/s" if bf16 else "3xTF32 at 495/3 TFLOP/s"
    log(f"B2 {dtype} all distinct shapes of one MSD pass (15 forward + 15 dx), device time: "
        f"kernel {totals['ms']:.3f} ms, plain {totals['plain_ms']:.3f} ms, grouped conv1d "
        f"{totals['library_ms']:.3f} ms; events: kernel {totals['ev_ms']:.3f} ms, plain "
        f"{totals['ev_plain_ms']:.3f} ms, conv1d {totals['ev_library_ms']:.3f} ms; bound "
        f"{totals['bound_ms']:.3f} ms ({rate}; {totals['bound_ms'] / totals['ms']:.1%}"
        f" reached), f32-FMA bound {totals['fma_bound_ms']:.3f} ms "
        f"({totals['fma_bound_ms'] / totals['ms']:.1%}); max|kernel - twin| {worst:.3e}"
        + (f", max excess over one bf16 ulp {worst_excess:.3e}; A moved into shared memory "
           f"{totals['a_window'] / 1e6:.1f} MB, {totals['a_ring'] / 1e6:.1f} MB by the ring's "
           f"gathers" if bf16 else "") + f" [{card}]")
    return {"name": "gouter_kernel.gouter_tap_dots_kernel" + ("[bf16]" if bf16 else ""),
            "dtype": "bfloat16" if bf16 else "float32", "route": "cuda",
            "source": "neuraltexttospeech_torch/ops/csrc/gouter_kernel.cu",
            "replaces": "neuraltexttospeech_tpu/ops/gouter_kernel.py:114",
            "launches": None, "max_abs_err": worst, "ms": totals["ms"],
            "plain_ms": totals["plain_ms"], "bound_ms": totals["bound_ms"],
            "bound_by": "operations" if totals["t_ops"] >= totals["t_bytes"] else "bytes",
            "library_ms": totals["library_ms"]}


def mas_bound_ms(batch, t_mel, t_text, out_lens):
    """Least time an H100 could take for MAS over these inputs (NVIDIA's SXM
    peaks): bytes at 3.35 TB/s — the log-attention rows the forward needs
    (4 B an element of the first min(out_len, T_mel) rows), the diagonal
    choices written for them (1 B) and the path written (4 B an element) —
    against about 4 f32 operations an element (add, two max, compare) at
    67 TFLOP/s. Returns ``(bound_ms, bound_by)``."""
    rows = sum(min(int(m), t_mel) for m in out_lens)
    nbytes = 5 * rows * t_text + 4 * batch * t_mel * t_text
    t_bytes, t_ops = nbytes / 3.35e12 * 1e3, 4 * rows * t_text / 67e12 * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# One dependent step of MAS's chain: a warp shuffle and an f32 max, in
# cycles (an assumed latency, not a measurement: the order of Hopper's
# shuffle and FP32 pipeline latencies); ``mas_chain_floor_ms`` multiplies it
# by the rows, the floor no schedule of the chain can go under.
MAS_STEP_CYCLES = 30


def mas_chain_floor_ms(t_mel, sm_mhz):
    """The chain's floor: ``t_mel`` dependent rows, each one shuffle and max
    (:data:`MAS_STEP_CYCLES`) at the card's SM clock."""
    return t_mel * MAS_STEP_CYCLES / (sm_mhz * 1e3)


def mas_phase_split(torch, mas_kernel, la, in_lens, out_lens):
    """One probe launch with the kernel's time stamps: mean over blocks of
    the forward, the backtrack and the zeros (from the kernel's start, µs by
    ``%globaltimer``), the ones and the whole block, and the forward's
    cycles per row (``clock64``)."""
    b, t_mel, _ = la.shape
    stamps = torch.zeros(b, mas_kernel.STAMPS, 2, dtype=torch.int64, device=la.device)
    mas_kernel.maximum_path(la, in_lens, out_lens, stamps=stamps)
    torch.cuda.synchronize()
    ns, cyc = stamps[..., 1].double().cpu(), stamps[..., 0].double().cpu()
    us = lambda k, j=0: float((ns[:, k] - ns[:, j]).mean()) / 1e3  # noqa: E731
    return {"forward_us": us(1), "backtrack_us": us(2, 1), "zeros_us": us(3),
            "ones_us": float((ns[:, 4] - ns[:, [2, 3]].max(dim=1).values).mean()) / 1e3,
            "block_us": us(4), "cycles_a_row": float((cyc[:, 1] - cyc[:, 0]).mean()) / t_mel}


def sm_clock_mhz():
    """The card's SM clock now and at most (nvidia-smi)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    now, most = (float(v) for v in out.split(","))
    return now, most


def phase_mas(torch, device, card):
    """MAS: the kernel against its plain twin on the card (bit for bit) at
    the ``bench.py`` FastPitch shape (16 × 768 mel frames × 128 tokens), at
    16 copies of the longest LJSpeech clip (870 × 192), both on log-softmax
    rows as FastPitch's aligner gives them, and at the Grad-TTS step's shape
    (``bench.py:519``: 16 × 512 × 160) on Grad-TTS's Gaussian log-prior of
    random mu and mels; timed beside the twin and the bound, with the
    kernel's own split into forward, backtrack and plane write. Returns the
    JSON record (the first shape)."""
    from neuraltexttospeech_torch.models.gradtts import gaussian_log_prior
    from neuraltexttospeech_torch.ops import mas_kernel

    record = None
    for b, t_mel, t_text in ((16, 768, 128), (16, 870, 192), (16, 512, 160)):
        gen = torch.Generator(device=device).manual_seed(t_mel)
        if t_mel == 512:
            mu = torch.randn(b, t_text, 80, device=device, generator=gen)
            y = torch.randn(b, t_mel, 80, device=device, generator=gen)
            la = gaussian_log_prior(mu, y).transpose(1, 2).contiguous()
            what = "Grad-TTS log-prior"
        else:
            la = torch.log_softmax(torch.randn(b, t_mel, t_text, device=device, generator=gen),
                                   -1)
            what = "log-softmax rows"
        in_lens = torch.full((b,), t_text, dtype=torch.int32, device=device)
        out_lens = torch.full((b,), t_mel, dtype=torch.int32, device=device)
        got = mas_kernel.maximum_path(la, in_lens, out_lens)
        want = mas_kernel.maximum_path_reference(la, in_lens, out_lens)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise RuntimeError(f"MAS kernel differs from its twin at {b}x{t_mel}x{t_text}: "
                               f"{int((got != want).sum())} elements")
        fns = {"kernel": lambda: mas_kernel.maximum_path(la, in_lens, out_lens),
               "plain": lambda: mas_kernel.maximum_path_reference(la, in_lens, out_lens)}
        ev = {"kernel": cuda_ms(fns["kernel"], 20), "plain": cuda_ms(fns["plain"], 3)}
        device_ms(torch, fns["kernel"], reps=10)
        # a call is one MAS kernel and nothing else: its device time is the
        # kernel's, per kernel the trace recorded (a trace now and then
        # misses one of its records)
        others = [name for _, name in device_breakdown.last if "mas_kernel" not in name]
        if others:
            raise RuntimeError(f"a MAS call ran other kernels: {others}")
        n_mas = sum(c for name, c in device_breakdown.counts.items() if "mas_kernel" in name)
        dev = {"kernel": sum(ms for ms, _ in device_breakdown.last) / n_mas,
               "plain": device_ms(torch, fns["plain"], reps=2)}
        bound_ms, bound_by = mas_bound_ms(b, t_mel, t_text, [t_mel] * b)
        split = mas_phase_split(torch, mas_kernel, la, in_lens, out_lens)
        now_mhz, max_mhz = sm_clock_mhz()
        floor_ms = mas_chain_floor_ms(t_mel, max_mhz)
        log(f"MAS {b}x{t_mel}x{t_text} ({what}): kernel == twin bit for bit; device time of the "
            f"call {dev['kernel'] * 1e3:.2f} us (one kernel a call, {n_mas} of 10 in the trace), "
            f"plain loop {dev['plain'] * 1e3:.1f} us; CUDA events over "
            f"back-to-back calls kernel {ev['kernel'] * 1e3:.2f} us, plain "
            f"{ev['plain'] * 1e3:.1f} us; bound {bound_ms * 1e3:.2f} us ({bound_by}), "
            f"{bound_ms / dev['kernel']:.1%} of it reached; the chain's floor {floor_ms * 1e3:.2f} "
            f"us ({t_mel} rows x {MAS_STEP_CYCLES} cycles, one shuffle and max, at "
            f"{max_mhz:.0f} MHz), {floor_ms / dev['kernel']:.1%} of it reached; "
            f"{dev['kernel'] / t_mel * 1e6:.1f} ns a row [{card}]")
        log(f"  MAS {b}x{t_mel}x{t_text} split (one probe launch with time stamps, mean over "
            f"blocks): forward {split['forward_us']:.2f} us ({split['cycles_a_row']:.1f} cycles "
            f"a row), backtrack {split['backtrack_us']:.2f} us, plane zeros done "
            f"{split['zeros_us']:.2f} us after the start (beside the forward), ones "
            f"{split['ones_us']:.2f} us; block {split['block_us']:.2f} us; SM clock "
            f"{now_mhz:.0f} MHz of {max_mhz:.0f}")
        if record is None:
            record = {"name": "mas_kernel.maximum_path", "route": "cuda",
                      "source": "neuraltexttospeech_torch/ops/csrc/mas_kernel.cu",
                      "replaces": "neuraltexttospeech_tpu/ops/mas.py:94",
                      "note": "the TPU version is a lax.scan, not a Pallas kernel",
                      "launches": None, "max_abs_err": 0.0, "ms": dev["kernel"],
                      "plain_ms": dev["plain"], "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": None}
        del la, got, want
    return record


def save_models(torch, device, fp_cfg, hg_cfg, seed, tag):
    from neuraltexttospeech_torch.models.hifigan import Generator
    from neuraltexttospeech_torch.models.registry import save_checkpoint

    fp = random_fastpitch(fp_cfg, seed, device)
    gen = random_init_(Generator(hg_cfg).to(device), seed + 1, device)
    fe = {"symbol_set": "english_basic", "text_cleaners": ["english_cleaners_v2"],
          "p_arpabet": 0.0}
    fp_dir = save_checkpoint(WORK / tag / "fastpitch", "FastPitch", fp_cfg,
                             fp.state_dict(), frontend=fe)
    hg_dir = save_checkpoint(WORK / tag / "hifigan", "HiFiGAN", hg_cfg, gen.state_dict())
    return fp_dir, hg_dir


def check_text2wav_outputs(out_dir, n_utts):
    from scipy.io import wavfile

    for j in range(n_utts):
        mel = np.load(out_dir / f"utt_{j:04d}_mel.npy")
        sr, audio = wavfile.read(out_dir / f"utt_{j:04d}.wav")
        assert mel.ndim == 2 and mel.shape[1] == 80 and np.isfinite(mel).all(), mel.shape
        assert sr == SR and audio.shape == (mel.shape[0] * HOP,), (audio.shape, mel.shape)


def phase_serving(torch, device):
    """Both serving entry points at full width, f32 and then ``--amp``
    (bf16). Returns B1's launch count of the f32 run."""
    from neuraltexttospeech_torch.audio.stft import num_frames
    from neuraltexttospeech_torch.cli import fastpitch_infer, hifigan_infer
    from neuraltexttospeech_torch.data.filelist import save_wav
    from neuraltexttospeech_torch.models.fastpitch import FastPitchConfig
    from neuraltexttospeech_torch.models.hifigan import HiFiGANConfig
    from neuraltexttospeech_torch.ops import mel_kernel

    fp_dir, hg_dir = save_models(torch, device, FastPitchConfig(), HiFiGANConfig.v1(),
                                 seed=0, tag="full")
    text_file = WORK / "sentences.txt"
    text_file.write_text("\n".join(SENTENCES) + "\n")
    wavs = synthetic_wavs(8, 10.0, seed=1)
    filelist = WORK / "wavs.txt"
    names = []
    for i, w in enumerate(wavs):
        path = WORK / "wavs" / f"synth_{i}.wav"
        save_wav(str(path), w, SR)
        names.append(str(path))
    filelist.write_text("\n".join(f"{p}|" for p in names) + "\n")

    from scipy.io import wavfile

    counts = {}
    for tag, flags in (("f32", []), ("bf16", ["--amp"])):
        mel_kernel.fused_frames_to_mel.launches = 0
        t0 = time.perf_counter()
        fastpitch_infer.main(["--checkpoint", str(fp_dir), "--hifigan-checkpoint", str(hg_dir),
                              "-i", str(text_file), "-o", str(WORK / f"text2wav_{tag}")]
                             + flags)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        hifigan_infer.main(["--checkpoint", str(hg_dir), "-i", str(filelist),
                            "-o", str(WORK / f"copysyn_{tag}")] + flags)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts[tag] = launches = mel_kernel.fused_frames_to_mel.launches

        check_text2wav_outputs(WORK / f"text2wav_{tag}", len(SENTENCES))
        pad = (1024 - HOP) // 2
        for i, w in enumerate(wavs):
            _, audio = wavfile.read(WORK / f"copysyn_{tag}" / f"synth_{i}.wav")
            assert audio.shape == (num_frames(w.size + 2 * pad, 1024, HOP) * HOP,), audio.shape
        log(f"main path ({tag}): text->wav {len(SENTENCES)} sentences {t1 - t0:.2f} s, "
            f"copy-synthesis {len(wavs)} x 10 s {t2 - t1:.2f} s (first calls, "
            f"checkpoint load included); B1 launches {launches}")
        if launches != len(wavs):
            raise RuntimeError(f"copy-synthesis ({tag}) launched the log-mel kernel {launches} "
                               f"times for {len(wavs)} wavs")
    return counts["f32"]


def b2_launches_per_step(segment_size):
    """Kernel B2's launches in one GAN step, from the model's layer plan:
    per gouter layer of the MSD, the discriminator lane runs a forward and a
    dx for the real and for the fake batch, and the generator lane a forward
    and a dx for the fake one."""
    return 6 * len(msd_tap_shapes(1, segment_size))


def training_wavs():
    """16 synthetic 1 s wavs and their filelist, for the GAN trainer."""
    from neuraltexttospeech_torch.data.filelist import save_wav

    filelist = WORK / "train.txt"
    if not filelist.exists():
        names = []
        for i, w in enumerate(synthetic_wavs(16, 1.0, seed=5)):
            path = WORK / "train_wavs" / f"synth_{i}.wav"
            save_wav(str(path), w, SR)
            names.append(str(path))
        filelist.write_text("\n".join(f"{p}|" for p in names) + "\n")
    return filelist


def phase_training(torch, device, card, amp=False):
    """The trainer CLI at v1 (batch 16 × 8192; f32 with TF32 off, or bf16
    with ``--amp``) on synthetic wavs: 2 steps, then --resume for a 3rd.
    Returns the launch counts and the trainer."""
    from neuraltexttospeech_torch.cli import hifigan_train
    from neuraltexttospeech_torch.ops import gouter_kernel, mel_kernel

    tag = "bf16" if amp else "f32"
    out = WORK / f"train_{tag}"
    args = ["--config", "v1", "-o", str(out), "--training-files", str(training_wavs()),
            "--steps-per-epoch", "1"] + (["--amp"] if amp else [])

    mel_kernel.fused_frames_to_mel.launches = 0
    gouter_kernel.gouter_tap_dots_kernel.launches = 0
    gouter_kernel.gouter_tap_dots_kernel.bf16_launches = 0
    t0 = time.perf_counter()
    first = hifigan_train.main(args + ["--epochs", "2"])
    resumed = hifigan_train.main(args + ["--epochs", "3", "--resume"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    b1 = mel_kernel.fused_frames_to_mel.launches
    b2 = gouter_kernel.gouter_tap_dots_kernel.launches
    b2_bf16 = gouter_kernel.gouter_tap_dots_kernel.bf16_launches

    steps = first["steps"] + resumed["steps"]
    trainer = resumed["trainer"]
    dtype = torch.bfloat16 if amp else None
    if (first["steps"], resumed["steps"], trainer.step, trainer.dtype) != (2, 1, 3, dtype):
        raise RuntimeError(f"trainer ran {first['steps']} + {resumed['steps']} steps, "
                           f"ended at step {trainer.step}, dtype {trainer.dtype}")
    for run in (first, resumed):
        bad = {k: v for k, v in run["metrics"].items() if not np.isfinite(v)}
        if bad or not run["metrics"]:
            raise RuntimeError(f"non-finite or missing losses: {run['metrics']}")
    want_b2 = b2_launches_per_step(trainer.config.segment_size)
    log(f"training path ({tag}): v1 GAN step, batch 16 x 8192, {steps} steps (2, then --resume "
        f"1) in {wall:.1f} s with set-up and checkpoints; B1 launches {b1} ({b1 / steps:g} per "
        f"step), B2 launches {b2} ({b2 / steps:g} per step, {want_b2} by the layer plan; "
        f"{b2_bf16} of them bf16); last losses "
        + " ".join(f"{k}={v:.4f}" for k, v in sorted(resumed["metrics"].items())) + f" [{card}]")
    if b1 != 3 * steps or b2 != want_b2 * steps or b2_bf16 != (b2 if amp else 0):
        raise RuntimeError(f"the {tag} GAN step launched B1 {b1} and B2 {b2} ({b2_bf16} bf16) "
                           f"times in {steps} steps; expected {3 * steps} and {want_b2 * steps}, "
                           f"{'all' if amp else 'none'} bf16")
    if any(p.dtype != torch.float32 for m in (trainer.gen, trainer.mpd, trainer.msd)
           for p in m.parameters()):
        raise RuntimeError(f"the {tag} trainer holds parameters that are not f32")
    from neuraltexttospeech_torch.cli import hifigan_infer

    gen, cfg = hifigan_infer.load_generator(out / "checkpoints" / "3", device)
    mel = torch.randn(1, 32, cfg.num_mels, device=device)
    with torch.no_grad():
        torch.testing.assert_close(gen(mel), trainer.gen(mel), rtol=1e-4, atol=1e-5)
    return {"b1": b1, "b2": b2, "b1_per_step": b1 // steps, "b2_per_step": b2 // steps,
            "trainer": trainer}


def phase_fine_tuning(torch, device, card):
    """One v1 GAN step (f32, batch 16 × 8192) through the trainer CLI's
    ``--fine-tuning-mel-dir``: the generator's input mels are the synthetic
    wavs' own log-mels (through B1 on the card, HiFi-GAN's centered padding),
    written as an acoustic model's ``<utt>_mel.npy`` would be. The batch
    brings both mels, so the step launches B1 once (the generated audio's
    mel) and B2 as in any GAN step."""
    from neuraltexttospeech_torch.cli import hifigan_infer, hifigan_train
    from neuraltexttospeech_torch.data.filelist import load_wav
    from neuraltexttospeech_torch.models.hifigan import HiFiGANConfig
    from neuraltexttospeech_torch.ops import gouter_kernel, mel_kernel

    filelist = training_wavs()
    mel_dir = WORK / "ft_mels"
    mel_dir.mkdir()
    cfg = HiFiGANConfig.v1()
    for line in filelist.read_text().splitlines():
        path = pathlib.Path(line.split("|")[0])
        audio, _ = load_wav(str(path), SR)
        np.save(mel_dir / path.name.replace(".wav", "_mel.npy"),
                hifigan_infer.wav_to_mel(audio, cfg, device).cpu().numpy())
    mel_kernel.fused_frames_to_mel.launches = 0
    gouter_kernel.gouter_tap_dots_kernel.launches = 0
    t0 = time.perf_counter()
    run = hifigan_train.main(["--config", "v1", "-o", str(WORK / "train_ft"),
                              "--training-files", str(filelist), "--steps-per-epoch", "1",
                              "--epochs", "1", "--fine-tuning-mel-dir", str(mel_dir)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    b1, b2 = mel_kernel.fused_frames_to_mel.launches, gouter_kernel.gouter_tap_dots_kernel.launches
    want_b2 = b2_launches_per_step(cfg.segment_size)
    log(f"fine-tuning path: v1 GAN step on acoustic-model mels, batch 16 x 8192, "
        f"{run['steps']} step in {wall:.1f} s with set-up; B1 launches {b1}, B2 {b2}; losses "
        + " ".join(f"{k}={v:.4f}" for k, v in sorted(run["metrics"].items())) + f" [{card}]")
    if run["steps"] != 1 or not all(np.isfinite(v) for v in run["metrics"].values()):
        raise RuntimeError(f"the fine-tuning step ran {run['steps']} steps: {run['metrics']}")
    if b1 != 1 or b2 != want_b2:
        raise RuntimeError(f"the fine-tuning step launched B1 {b1} and B2 {b2} times; "
                           f"expected 1 and {want_b2}")


def counted_kernels():
    """The wrappers whose ``launches`` count the kernels' launches: B1, B2
    and MAS."""
    from neuraltexttospeech_torch.ops import gouter_kernel, mas_kernel, mel_kernel

    return (mel_kernel.fused_frames_to_mel, gouter_kernel.gouter_tap_dots_kernel,
            mas_kernel.maximum_path)


def phase_fastpitch_training(torch, device, card):
    """FastPitch training through its CLIs at full width: dataset prep of 16
    synthetic wavs with the ``SENTENCES`` texts on the card (B1 once per
    wav), then batch 16 in f32 and with ``--amp`` (bf16), each 2 steps and
    ``--resume`` for a 3rd; MAS once per step; the serving loader gives the
    trainer's model. Returns the counts."""
    from neuraltexttospeech_torch.cli import fastpitch_prepare_dataset, fastpitch_train
    from neuraltexttospeech_torch.data.filelist import save_wav
    from neuraltexttospeech_torch.models.registry import load_checkpoint
    from neuraltexttospeech_torch.ops import gouter_kernel, mas_kernel, mel_kernel

    rng = np.random.default_rng(9)
    lines = []
    for i, text in enumerate(SENTENCES):
        path = WORK / "fp_wavs" / f"fp_{i}.wav"
        save_wav(str(path), synthetic_wavs(1, 1.5 + 2.0 * rng.uniform(), seed=20 + i)[0], SR)
        lines.append(f"{path}|{text}")
    filelist = WORK / "fp_train.txt"
    filelist.write_text("\n".join(lines) + "\n")
    feats = WORK / "fp_feats"

    mel_kernel.fused_frames_to_mel.launches = 0
    t0 = time.perf_counter()
    fastpitch_prepare_dataset.main(["-d", str(feats), "--training-files", str(filelist)])
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    b1_prep = mel_kernel.fused_frames_to_mel.launches
    if b1_prep != len(SENTENCES):
        raise RuntimeError(f"dataset prep launched B1 {b1_prep} times for {len(SENTENCES)} wavs")

    out = {"b1_prep": b1_prep}
    for tag, flags in (("f32", []), ("bf16", ["--amp"])):
        run_dir = WORK / f"fp_train_{tag}"
        args = ["-o", str(run_dir), "-d", str(feats), "--training-files", str(filelist),
                "-bs", "16", "--steps-per-epoch", "1"] + flags
        for counted in counted_kernels():
            counted.launches = 0
        t0 = time.perf_counter()
        first = fastpitch_train.main(args + ["--epochs", "2"])
        resumed = fastpitch_train.main(args + ["--epochs", "3", "--resume"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        mas = mas_kernel.maximum_path.launches
        b1 = mel_kernel.fused_frames_to_mel.launches
        b2 = gouter_kernel.gouter_tap_dots_kernel.launches

        steps = first["steps"] + resumed["steps"]
        trainer = resumed["trainer"]
        if (first["steps"], resumed["steps"], trainer.step, trainer.dtype) != (2, 1, 3,
                                                                    torch.bfloat16 if flags else None):
            raise RuntimeError(f"FastPitch trainer ({tag}) ran {first['steps']} + "
                               f"{resumed['steps']} steps, ended at step {trainer.step}")
        for run in (first, resumed):
            bad = {k: v for k, v in run["metrics"].items() if not np.isfinite(v)}
            if bad or not run["metrics"]:
                raise RuntimeError(f"non-finite or missing FastPitch losses: {run['metrics']}")
        log(f"FastPitch training path ({tag}): dataset prep of {len(SENTENCES)} wavs "
            f"{prep_s:.1f} s (B1 launches {b1_prep}); full width, batch 16, {steps} steps (2, "
            f"then --resume 1) in {wall:.1f} s with set-up and checkpoints; MAS launches {mas} "
            f"({mas / steps:g} per step), B1 {b1}, B2 {b2}; last losses "
            + " ".join(f"{k}={v:.4f}" for k, v in sorted(resumed["metrics"].items()))
            + f" [{card}]")
        if mas != steps or b1 or b2:
            raise RuntimeError(f"the FastPitch step ({tag}) launched MAS {mas}, B1 {b1}, B2 {b2} "
                               f"times in {steps} steps; expected {steps}, 0, 0")
        served, _ = load_checkpoint(run_dir / "checkpoints" / "3", "FastPitch", device)
        text = torch.randint(1, 148, (4, 32), device=device,
                             generator=torch.Generator(device=device).manual_seed(0))
        model = trainer.model.eval()
        with torch.no_grad():
            for x, y in zip(served.infer(text, None, max_mel_len=256),
                            model.infer(text, None, max_mel_len=256)):
                torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)
        out[tag] = {"mas": mas, "mas_per_step": mas // steps}
        del trainer, first, resumed, model, served
    return out


# the small FastPitch of the committed golden (tools/make_goldens.py:62-69)
FP_TINY = dict(n_symbols=40, symbols_embedding_dim=64, in_fft_n_layers=1, in_fft_d_head=16,
               in_fft_n_heads=2, in_fft_conv1d_filter_size=128, out_fft_n_layers=1,
               out_fft_d_head=16, out_fft_n_heads=2, out_fft_conv1d_filter_size=128,
               dur_predictor_filter_size=32, pitch_predictor_filter_size=32,
               energy_predictor_filter_size=32)


def fastpitch_batch(seed, batch, t_text, t_mel, n_symbols, text_lens, mel_lens):
    """A random FastPitch batch (numpy), padded past the given lengths."""
    rng = np.random.default_rng(seed)
    text_lens, mel_lens = np.asarray(text_lens, np.int32), np.asarray(mel_lens, np.int32)
    text = rng.integers(1, n_symbols, (batch, t_text)).astype(np.int32)
    text[np.arange(t_text)[None] >= text_lens[:, None]] = 0
    valid = np.arange(t_mel)[None, :, None] < mel_lens[:, None, None]
    pitch = rng.standard_normal((batch, 1, t_mel)).astype(np.float32)
    pitch[rng.uniform(size=pitch.shape) < 0.3] = 0.0
    return {"text": text, "input_lens": text_lens, "mel_lens": mel_lens,
            "mel": (rng.standard_normal((batch, t_mel, 80)) * valid).astype(np.float32),
            "pitch": pitch,
            "energy": np.abs(rng.standard_normal((batch, t_mel))).astype(np.float32)}


def bf16_yardstick(what, card, cpu_bf16, cpu_f32):
    """tests/test_torch_bf16.py's yardstick with the CPU run in the place of
    JAX: |card - CPU| in bf16 at most twice the CPU's own bf16 error plus
    1e-3 of the f32 value's size. Returns (e_card, e_cpu)."""
    card, cb, cf = (np.asarray(a, np.float64) for a in (card, cpu_bf16, cpu_f32))
    e_card, e_cpu = np.abs(card - cb).max(), np.abs(cb - cf).max()
    if e_card > 2 * e_cpu + 1e-3 * np.abs(cf).max():
        raise RuntimeError(f"bf16 {what}: card vs CPU {e_card:.3e} beyond twice the CPU's bf16 "
                           f"error {e_cpu:.3e} + 1e-3 of the f32 value")
    return e_card, e_cpu


def bf16_grad_errors(grads):
    """Each parameter's (|card bf16 - CPU bf16|, |CPU bf16 - CPU f32|,
    max|CPU f32|, |card bf16 - card f32|) from ``grads``, which maps (amp,
    device type) to the step's gradients."""
    leaves = {}
    for k, v in grads[(False, "cpu")].items():
        card, cb, cf, gf = (t.double() for t in (grads[(True, "cuda")][k], grads[(True, "cpu")][k],
                                                 v, grads[(False, "cuda")][k]))
        leaves[k] = np.array([(card - cb).abs().max().item(), (cb - cf).abs().max().item(),
                              cf.abs().max().item(), (card - gf).abs().max().item()])
    return leaves


def check_bf16_step(label, metrics, params, grads, lr):
    """A bf16 train step card vs CPU: metrics by :func:`bf16_yardstick`; the
    gradients by it too, as tests/test_torch_bf16.py's ``grads_yardstick``
    holds them against JAX (the whole gradient as one tensor, and the median
    over parameters of each one's |card - CPU| over its own bound);
    parameters within 2.5 lr + 1e-6 (an Adam step is about lr sign(g), so
    this bound alone would hold any gradient). ``metrics``/``params``/
    ``grads`` map (amp, device type) to the step's outputs. Logs the card's
    own bf16 error (card bf16 vs card f32) beside the bounds, which it does
    not enter."""
    worst_m = {}
    for k, v in metrics[(False, "cpu")].items():
        worst_m[k] = bf16_yardstick(f"{label} {k}", metrics[(True, "cuda")][k],
                                    metrics[(True, "cpu")][k], v)
    ratios, e, leaves = [], np.zeros(4), bf16_grad_errors(grads)
    for k, leaf in leaves.items():
        e = np.maximum(e, leaf)
        bound = 2 * leaf[1] + 1e-3 * leaf[2]
        ratios.append((leaf[0] / bound if bound > 0 else float(leaf[0] > 0), k))
    median = float(np.median([r for r, _ in ratios]))
    whole = 2 * e[1] + 1e-3 * e[2]
    worst = max(ratios)
    far = leaves[worst[1]]
    summary = (f"gradients {e[0]:.2e}/{e[1]:.2e} (bound {whole:.2e}; card bf16 vs f32 "
               f"{e[3]:.2e}), median {median:.2f} of each parameter's bound, "
               f"{sum(r > 1 for r, _ in ratios)} of {len(ratios)} past it, the farthest "
               f"{worst[1]} ({worst[0]:.2f}: |card - CPU| {far[0]:.2e}, CPU bf16 vs f32 "
               f"{far[1]:.2e}, card bf16 vs f32 {far[3]:.2e}, max|grad| {far[2]:.2e})")
    if e[0] > whole or median > 1.0:
        raise RuntimeError(f"bf16 {label}: {summary}")
    worst_p = 0.0
    for k, v in params[(True, "cpu")].items():
        d = (params[(True, "cuda")][k].double() - v.double()).abs().max().item()
        if ".sn." in k:  # spectral-norm stats: f32 from f32 weights in both modes
            np.testing.assert_allclose(params[(True, "cuda")][k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
        elif d > 2.5 * lr + 1e-6:
            raise RuntimeError(f"bf16 {label} parameter {k}: card vs CPU {d:.3e} > 2.5 lr")
        worst_p = max(worst_p, d)
    log(f"reference: {label} bf16 card vs CPU: metrics (|card - CPU|, CPU bf16 vs f32) "
        + ", ".join(f"{k} {a:.2e}/{b:.2e}" for k, (a, b) in sorted(worst_m.items()))
        + f"; {summary}; max|param diff| {worst_p:.2e} (bound {2.5 * lr + 1e-6:.2e})")


def phase_fastpitch_reference(torch, device):
    """One FastPitch train step of the golden's small FastPitch, dropout off:
    card vs CPU from the same weights and batch, at the tolerances of
    tests/test_torch_fastpitch_optim.py (metrics rtol 2e-4, parameters rtol
    3e-3 / atol 3e-5, Adam eps 1e-6); then the same step in bf16, held to
    :func:`check_bf16_step`."""
    import dataclasses

    from neuraltexttospeech_torch.cli.fastpitch_train import make_loss_fn
    from neuraltexttospeech_torch.models.fastpitch import FastPitch, FastPitchConfig
    from neuraltexttospeech_torch.models.fastpitch_loss import FastPitchLossConfig

    no_dropout = {f.name: 0.0 for f in dataclasses.fields(FastPitchConfig)
                  if f.name.startswith("p_")}
    cfg = FastPitchConfig(**FP_TINY, **no_dropout)
    torch.manual_seed(3)
    weights = FastPitch(cfg).state_dict()
    batch = fastpitch_batch(4, 3, 16, 48, 40, [16, 10, 6], [48, 37, 20])
    steps = train_steps_card_and_cpu(torch, lambda: FastPitch(cfg), weights,
                                     make_loss_fn(FastPitchLossConfig(), 1),
                                     dict(learning_rate=1e-3, eps=1e-6), batch, device)
    check_bf16_step("small FastPitch train step", *({k: v[i] for k, v in steps.items()}
                                                    for i in range(3)), 1e-3)
    check_f32_step("small FastPitch train step", steps)


def phase_gan_reference(torch, device):
    """One GAN step of TINY's generator with the full MPD and MSD (gouter
    path, B2 on the card): card vs CPU from the same weights and batch, at
    tests/test_hifigan.py:211-217's tolerances; then the same step in bf16
    (B2's bf16 form on the card), held to :func:`check_bf16_step`."""
    from neuraltexttospeech_torch.models.hifigan import HiFiGANConfig
    from neuraltexttospeech_torch.models.hifigan_gan import HiFiGANTrainer

    cfg = HiFiGANConfig(resblock="2", upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                        upsample_initial_channel=32, resblock_kernel_sizes=(3,),
                        resblock_dilation_sizes=((1, 2),), n_fft=64, hop_size=16,
                        win_size=64, segment_size=256, num_mels=8,
                        fast_grouped_convs="gdot_pallas")
    audio = (np.random.default_rng(8).standard_normal((4, 256, 1)) * 0.1).astype(np.float32)
    cpu = torch.device("cpu")
    steps = {}
    for amp in (False, True):
        for dev in (device, cpu):
            trainer = HiFiGANTrainer(cfg, dev, dtype=torch.bfloat16 if amp else None)
            metrics = trainer.train_step({"audio": torch.as_tensor(audio, device=dev)})
            state = {f"{name}.{k}": v.detach().cpu()
                     for name in ("gen", "mpd", "msd")
                     for k, v in getattr(trainer, name).state_dict().items()}
            grads = {f"{name}.{k}": p.grad.cpu() for name in ("gen", "mpd", "msd")
                     for k, p in getattr(trainer, name).named_parameters()}
            steps[(amp, dev.type)] = ({k: float(v) for k, v in metrics.items()}, state, grads)
    out = {dev: steps[(False, dev)] for dev in ("cuda", "cpu")}
    check_bf16_step("TINY GAN step", *({k: v[i] for k, v in steps.items()} for i in range(3)),
                    cfg.learning_rate)
    worst_m = max(abs(out["cuda"][0][k] - out["cpu"][0][k]) for k in out["cpu"][0])
    for k, v in out["cpu"][0].items():
        np.testing.assert_allclose(out["cuda"][0][k], v, rtol=2e-4, atol=2e-5, err_msg=k)
    worst_p = 0.0
    for k, v in out["cpu"][1].items():
        tol = dict(rtol=1e-4, atol=1e-6) if ".sn." in k else dict(rtol=3e-3, atol=3e-5)
        np.testing.assert_allclose(out["cuda"][1][k].numpy(), v.numpy(), err_msg=k, **tol)
        worst_p = max(worst_p, (out["cuda"][1][k] - v).abs().max().item())
    log(f"reference: TINY GAN step (full MPD + MSD through B2) card vs CPU: max|metric diff| "
        f"{worst_m:.2e}, max|param/stat diff| {worst_p:.2e}")


def phase_reference(torch, device):
    """Small-width text → wav and copy-synthesis: card vs CPU, same weights."""
    from neuraltexttospeech_torch.cli import fastpitch_infer, hifigan_infer
    from neuraltexttospeech_torch.models.fastpitch import FastPitchConfig
    from neuraltexttospeech_torch.models.hifigan import HiFiGANConfig
    from neuraltexttospeech_torch.models.registry import load_checkpoint

    fp_cfg = FastPitchConfig(symbols_embedding_dim=64, in_fft_n_layers=2, out_fft_n_layers=2,
                             in_fft_n_heads=2, out_fft_n_heads=2, in_fft_d_head=16,
                             out_fft_d_head=16, in_fft_conv1d_filter_size=128,
                             out_fft_conv1d_filter_size=128)
    hg_cfg = HiFiGANConfig.v1(upsample_initial_channel=32)
    fp_dir, hg_dir = save_models(torch, device, fp_cfg, hg_cfg, seed=7, tag="small")
    cpu = torch.device("cpu")
    tp = fastpitch_infer.text_processing(fp_dir)
    encoded = [np.asarray(tp.encode_text(s), np.int32) for s in SENTENCES[:8]]
    outs = {}
    for dev in (device, cpu):
        fp, _ = load_checkpoint(fp_dir, "FastPitch", dev)
        gen, _ = load_checkpoint(hg_dir, "HiFiGAN", dev)
        outs[dev.type] = sorted(fastpitch_infer.synthesize(fp, gen, encoded, device=dev),
                                key=lambda r: r[0])
    worst_mel = worst_audio = 0.0
    for (j, mg, ag), (_, mc, ac) in zip(outs["cuda"], outs["cpu"]):
        assert mg.shape == mc.shape, (j, mg.shape, mc.shape)  # same dec_lens
        assert np.isfinite(ag).all() and np.abs(ag).max() <= 1.0
        worst_mel = max(worst_mel, float(np.abs(mg - mc).max()))
        worst_audio = max(worst_audio, float(np.abs(ag - ac).max()))
    log(f"reference: small text->wav card vs CPU: max|mel diff| {worst_mel:.2e}, "
        f"max|audio diff| {worst_audio:.2e}")
    if worst_mel > 1e-4 or worst_audio > 1e-4:
        raise RuntimeError("text->wav on the card disagrees with the CPU run")

    wav = synthetic_wavs(1, 2.0, seed=3)[0]
    gen_cpu, _ = load_checkpoint(hg_dir, "HiFiGAN", cpu)
    gen_gpu, cfg = load_checkpoint(hg_dir, "HiFiGAN", device)
    mel_gpu = hifigan_infer.wav_to_mel(wav, cfg, device)  # the kernel
    mel_cpu = hifigan_infer.wav_to_mel(wav, cfg, cpu)     # plain rFFT path
    torch.testing.assert_close(mel_gpu.cpu(), mel_cpu, atol=1e-3, rtol=1e-4)
    a_gpu = hifigan_infer.vocode(gen_gpu, mel_gpu[None])[0].cpu()
    a_cpu = hifigan_infer.vocode(gen_cpu, mel_gpu.cpu()[None])[0]
    d = (a_gpu - a_cpu).abs().max().item()
    log(f"reference: copy-synthesis card vs CPU: max|mel diff| "
        f"{(mel_gpu.cpu() - mel_cpu).abs().max().item():.2e}, max|audio diff| {d:.2e}")
    if d > 1e-4:
        raise RuntimeError("copy-synthesis on the card disagrees with the CPU run")


def device_breakdown(torch, fn, top=6):
    """One traced call of ``fn``: the card's busy time (ms, the union of its
    kernels' intervals, so kernels that overlap count once) and the kernels
    that took most time, as ``[(ms, name)]``, read by
    ``utils/profiling.py::breakdown``. Every kernel's summed time, the sum over
    all of them and the number of device events stay on
    ``device_breakdown.last``, ``.kernel_sum`` and ``.launches``, each
    kernel's count on ``.counts``, the host's CUDA runtime calls on
    ``.runtime``, its aten ops' counts on ``.ops`` and the whole
    ``Breakdown`` on ``.result``."""
    from neuraltexttospeech_torch.utils.profiling import breakdown
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    b = breakdown(prof)
    kernels = [(ms, name) for name, (ms, _) in b.kernels.items()]
    device_breakdown.result = b
    device_breakdown.last = kernels
    device_breakdown.kernel_sum = b.kernel_sum_ms
    device_breakdown.launches = b.launches
    device_breakdown.counts = {name: count for name, (_, count) in b.kernels.items()}
    device_breakdown.ops = b.ops
    device_breakdown.runtime = b.runtime  # host side: CUDA runtime calls, (count, ms)
    return b.busy_ms, sorted(kernels, reverse=True)[:top]


def phase_timing(torch, device, card):
    """text → wav at bench.py's shape: batch 8 × 128 tokens, 1024 frames."""
    from neuraltexttospeech_torch.models.fastpitch import FastPitchConfig
    from neuraltexttospeech_torch.models.hifigan import Generator, HiFiGANConfig
    from neuraltexttospeech_torch.nn.precision import compute_dtype

    B, T_TEXT, MAX_MEL = 8, 128, 1024
    cfg = FastPitchConfig()
    fp = random_fastpitch(cfg, 0, device)
    gen = random_init_(Generator(HiFiGANConfig.v1()).to(device).eval(), 1, device)
    rng = np.random.default_rng(0)
    text = torch.as_tensor(rng.integers(1, cfg.n_symbols, (B, T_TEXT)), device=device)
    lens = torch.full((B,), T_TEXT, device=device)
    audio_s = B * MAX_MEL * HOP / SR

    for amp in (False, True):
        def run():
            with torch.inference_mode(), compute_dtype(torch.bfloat16 if amp else None):
                mel = fp.infer(text, lens, max_mel_len=MAX_MEL)[0]
                return mel, gen(mel)

        mel, audio = run()
        torch.cuda.synchronize()
        assert audio.shape == (B, MAX_MEL * HOP, 1) and torch.isfinite(audio.float()).all()
        assert audio.abs().max().item() <= 1.0
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall = float(np.median(walls))
        with torch.inference_mode(), compute_dtype(torch.bfloat16 if amp else None):
            fp_ms = cuda_ms(lambda: fp.infer(text, lens, max_mel_len=MAX_MEL), 3)
            gen_ms = cuda_ms(lambda: gen(mel), 3)
        name = "bf16 (--amp)" if amp else "f32 (TF32 off)"
        log(f"text->wav {name}: batch {B}x{T_TEXT} tokens, {MAX_MEL} frames = "
            f"{audio_s:.3f} s audio: wall {wall:.4f} s (runs {', '.join(f'{w:.4f}' for w in walls)}) "
            f"= {wall / audio_s:.3e} s per audio s; FastPitch {fp_ms:.2f} ms, "
            f"generator {gen_ms:.2f} ms; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
            f"[{card}]")
        busy, top = device_breakdown(torch, run)
        log(f"  trace: card busy {busy:.2f} ms of {wall * 1e3:.2f} ms wall, idle share "
            f"{1 - busy / (wall * 1e3):.3f}; top: "
            + "; ".join(f"{ms:.2f} ms {name[:70]}" for ms, name in top))

    # copy-synthesis of one 10 s wav, f32: the kernel's log-mel, then v1
    from neuraltexttospeech_torch.audio.stft import num_frames
    from neuraltexttospeech_torch.cli import hifigan_infer

    wav = synthetic_wavs(1, 10.0, seed=2)[0]
    hg_cfg = HiFiGANConfig.v1()

    def copy_synthesis():
        return hifigan_infer.vocode(gen, hifigan_infer.wav_to_mel(wav, hg_cfg, device)[None])

    audio = copy_synthesis()
    n_frames = num_frames(wav.size + hg_cfg.n_fft - HOP, 1024, HOP)
    assert audio.shape == (1, n_frames * HOP) and torch.isfinite(audio).all()
    assert audio.abs().max().item() <= 1.0
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        copy_synthesis()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    busy, top = device_breakdown(torch, copy_synthesis)
    log(f"copy-synthesis f32 (TF32 off): one 10 s wav: wall {wall:.4f} s = "
        f"{wall / 10.0:.3e} s per audio s [{card}]")
    log(f"  trace: card busy {busy:.2f} ms of {wall * 1e3:.2f} ms wall, idle share "
        f"{1 - busy / (wall * 1e3):.3f}; top: "
        + "; ".join(f"{ms:.2f} ms {name[:70]}" for ms, name in top))


def phase_train_timing(torch, trainer, card):
    """The v1 GAN step (batch 16 × 8192) on the CLI's trainer (f32, or bf16
    for an ``--amp`` trainer): wall ms and samples/s (median of 3
    synchronised steps), the generator's share (CUDA events over its forward
    and backward), and a profiler split with the idle share and launches."""
    from neuraltexttospeech_torch.nn.precision import compute_dtype

    mode = "bf16 (--amp)" if trainer.dtype == torch.bfloat16 else "f32 (TF32 off)"
    rng = np.random.default_rng(6)
    cfg = trainer.config
    batch = {"audio": torch.as_tensor((rng.standard_normal((16, cfg.segment_size, 1)) * 0.1)
                                      .astype(np.float32), device=trainer.device)}
    trainer.train_step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, hosts = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        trainer.train_step(batch)
        hosts.append(time.perf_counter() - t0)  # the host has issued the step
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    samples = 16 * cfg.segment_size
    mel = torch.randn(16, cfg.segment_size // cfg.hop_size, cfg.num_mels, device=trainer.device)
    dy = torch.randn(16, cfg.segment_size, 1, device=trainer.device)
    with compute_dtype(trainer.dtype):
        gen_ms = cuda_ms(lambda: torch.autograd.backward(trainer.gen(mel), dy), 3)
    trainer.gen.zero_grad(set_to_none=True)
    log(f"GAN step v1 {mode}: batch 16 x {cfg.segment_size}: wall {wall * 1e3:.1f} ms "
        f"(runs {', '.join(f'{w * 1e3:.1f}' for w in walls)}; host done issuing after "
        f"{', '.join(f'{h * 1e3:.1f}' for h in hosts)}) = {samples / wall:.0f} samples/s; "
        f"generator forward+backward {gen_ms:.1f} ms ({gen_ms / (wall * 1e3):.1%}); peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    busy, top = device_breakdown(torch, lambda: trainer.train_step(batch), top=8)
    b2 = sum(ms for ms, name in device_breakdown.last if any(k in name for k in B2_KERNELS))
    b1 = sum(ms for ms, name in device_breakdown.last if "mel_" in name and "_kernel" in name)
    # B2's time counts its main kernel (of either form) and its prologue,
    # each once per call
    per_step = b2_launches_per_step(cfg.segment_size)
    for kernels in (B2_MAIN_KERNELS, ("pack_weights_kernel",)):
        n = sum(c for name, c in device_breakdown.counts.items()
                if any(k in name for k in kernels))
        if n != per_step:
            raise RuntimeError(f"the traced {mode} GAN step ran {' or '.join(kernels)} {n} "
                               f"times, not {per_step}: B2's time would be misread")
    launches, copies, casts, attrs = launch_counts()
    log(f"  trace ({mode}): card busy {busy:.2f} ms of {wall * 1e3:.2f} ms wall (kernel times "
        f"sum to {device_breakdown.kernel_sum:.2f} ms), idle share "
        f"{1 - busy / (wall * 1e3):.3f}, {device_breakdown.launches} device events, {launches} "
        f"host kernel launches ({copies} of them copy kernels; {casts} dtype casts), {attrs} "
        f"cudaFuncGetAttributes; B2 {b2:.2f} ms ({b2 / device_breakdown.kernel_sum:.1%} of "
        f"kernel time, {per_step} main and {per_step} prologue launches), B1 {b1:.3f} ms; top: "
        + "; ".join(f"{ms:.2f} ms {name[:70]}" for ms, name in top))
    runtime = sorted(device_breakdown.runtime.items(), key=lambda kv: -kv[1][1])[:5]
    log("  host: CUDA runtime calls " + "; ".join(
        f"{name} x{count} {ms:.1f} ms" for name, (count, ms) in runtime))
    # where the launches come from: each network's forward and backward
    # (inputs and parameters both take gradients, as in the step's two lanes)
    y = batch["audio"].clone().requires_grad_()
    nets = {"generator": lambda: [trainer.gen(mel)],
            "MPD": lambda: trainer.mpd.scores(y)[0],
            "MSD": lambda: trainer.msd.scores(y, update_stats=False)[0]}
    split = []
    for name, fwd in nets.items():
        def run():
            with compute_dtype(trainer.dtype):
                outs = fwd()
            sum(o.float().sum() for o in outs).backward()
        run()
        device_breakdown(torch, run)
        launches, copies, casts, attrs = launch_counts()
        split.append(f"{name} {launches} ({copies} copy kernels, {casts} dtype casts, {attrs} "
                     f"cudaFuncGetAttributes)")
    for m in (trainer.gen, trainer.mpd, trainer.msd):
        m.zero_grad(set_to_none=True)
    log(f"  host kernel launches by network, forward + backward ({mode}): " + "; ".join(split))


def launch_counts():
    """From the last :func:`device_breakdown`: the host's kernel launches,
    the device's copy kernels (PyTorch's ``direct_copy_kernel``: dtype casts
    and layout copies), the dtype casts (``aten::_to_copy`` ops, forward and
    backward) and the host's ``cudaFuncGetAttributes`` calls."""
    launches = sum(count for name, (count, _) in device_breakdown.runtime.items()
                   if "LaunchKernel" in name)
    copies = sum(c for name, c in device_breakdown.counts.items() if "copy_kernel" in name)
    attrs = sum(count for name, (count, _) in device_breakdown.runtime.items()
                if "FuncGetAttributes" in name)
    return launches, copies, device_breakdown.ops.get("aten::_to_copy", 0), attrs


def phase_fastpitch_timing(torch, device, card, amp=False):
    """The FastPitch train step at the ``bench.py`` shape (16 × 128 tokens ×
    768 mel frames, random batch, full width, dropout on; f32 with TF32 off,
    or bf16 with ``amp``): wall ms (median of 5 synchronised steps) and mel
    frames/s, the profiler's busy time and idle share, the top kernels, MAS's
    share and the host's kernel launches per step."""
    from neuraltexttospeech_torch.cli.fastpitch_train import make_loss_fn
    from neuraltexttospeech_torch.models.fastpitch import FastPitch, FastPitchConfig
    from neuraltexttospeech_torch.models.fastpitch_loss import FastPitchLossConfig
    from neuraltexttospeech_torch.train.harness import Trainer, TrainerConfig

    B, T_TEXT, T_MEL = 16, 128, 768
    torch.manual_seed(0)
    trainer = Trainer(make_loss_fn(FastPitchLossConfig(), 1), FastPitch(FastPitchConfig()),
                      TrainerConfig(), device, dtype=torch.bfloat16 if amp else None)
    mode = "bf16 (--amp)" if amp else "f32 (TF32 off)"
    batch = {k: torch.as_tensor(v, device=device) for k, v in fastpitch_batch(
        5, B, T_TEXT, T_MEL, 148, [T_TEXT] * B, [T_MEL] * B).items()}
    for _ in range(2):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, hosts = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch)
        hosts.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    if not all(np.isfinite(float(v)) for v in metrics.values()):
        raise RuntimeError(f"non-finite FastPitch metrics at the bench shape: {metrics}")
    wall = float(np.median(walls))
    log(f"FastPitch train step {mode}, full width, dropout on: batch {B} x {T_TEXT} "
        f"tokens x {T_MEL} frames: wall {wall * 1e3:.1f} ms (runs "
        f"{', '.join(f'{w * 1e3:.1f}' for w in walls)}; host done issuing after "
        f"{', '.join(f'{h * 1e3:.1f}' for h in hosts)}) = {B * T_MEL / wall:.0f} mel frames/s; "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    busy, top = device_breakdown(torch, lambda: trainer.train_step(batch), top=8)
    mas = sum(ms for ms, name in device_breakdown.last if "mas_kernel" in name)
    launches = sum(count for name, (count, _) in device_breakdown.runtime.items()
                   if "LaunchKernel" in name)
    log(f"  trace ({mode}): card busy {busy:.2f} ms of {wall * 1e3:.2f} ms wall (kernel times "
        f"sum to {device_breakdown.kernel_sum:.2f} ms), idle share "
        f"{1 - busy / (wall * 1e3):.3f}, {device_breakdown.launches} device events, {launches} "
        f"host kernel launches; MAS "
        f"{mas:.3f} ms ({mas / device_breakdown.kernel_sum:.1%} of kernel time); top: "
        + "; ".join(f"{ms:.2f} ms {name[:70]}" for ms, name in top))
    runtime = sorted(device_breakdown.runtime.items(), key=lambda kv: -kv[1][1])[:5]
    log("  host: CUDA runtime calls " + "; ".join(
        f"{name} x{count} {ms:.1f} ms" for name, (count, ms) in runtime))


def timed_calls(torch, fn, reps):
    """One warm call, then ``reps`` synchronised calls of ``fn``: (median wall
    s, walls, host issue times, the last call's result); the peak memory
    counter is reset after the warm call."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, hosts = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        hosts.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls)), walls, hosts, out


def trace_summary(torch, fn, wall, top=8):
    """One traced call of ``fn``: busy time, idle share against ``wall``, the
    device events, the host's kernel launches and the top kernels."""
    busy, tops = device_breakdown(torch, fn, top=top)
    return (f"card busy {busy:.2f} ms of {wall * 1e3:.2f} ms wall, idle share "
            f"{1 - busy / (wall * 1e3):.3f}, {device_breakdown.launches} device events, "
            f"{launch_counts()[0]} host kernel launches; top: "
            + "; ".join(f"{ms:.2f} ms {name[:70]}" for ms, name in tops))


def runs(walls):
    return ", ".join(f"{w * 1e3:.1f}" for w in walls)


DW_ADAM = dict(learning_rate=2e-4, beta1=0.9, beta2=0.999, eps=1e-8, grad_clip_norm=None)


def phase_diffwave_cli(torch, device, card):
    """DiffWave through its CLIs at full width (30 layers × 64 channels):
    ``diffwave_train`` on the synthetic wavs (batch 16 × 62 frames, with
    validation on the same list), 2 steps then ``--resume`` for a 3rd, f32
    and ``--amp``; the dataset computes each batch's two mels on the card
    (B1 twice a batch, training and validation); then ``diffwave_infer
    --fast``, whole and ``--chunked``, on the trained checkpoint. Between
    the two, one batch of the dataset on the card against the host's.
    Returns B1's launches per batch."""
    from scipy.io import wavfile

    from neuraltexttospeech_torch.cli import diffwave_infer, diffwave_train
    from neuraltexttospeech_torch.data.mel_dataset import VocoderDataset
    from neuraltexttospeech_torch.ops import mel_kernel

    filelist = training_wavs()
    for tag, flags in (("f32", []), ("bf16", ["--amp"])):
        out = WORK / f"dw_train_{tag}"
        args = ["-o", str(out), "--training-files", str(filelist), "--validation-files",
                str(filelist), "--steps-per-epoch", "1"] + flags
        mel_kernel.fused_frames_to_mel.launches = 0
        t0 = time.perf_counter()
        first = diffwave_train.main(args + ["--epochs", "2"])
        resumed = diffwave_train.main(args + ["--epochs", "3", "--resume"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        b1 = mel_kernel.fused_frames_to_mel.launches
        trainer = resumed["trainer"]
        if (first["steps"], resumed["steps"], trainer.step) != (2, 1, 3):
            raise RuntimeError(f"DiffWave trainer ({tag}) ran {first['steps']} + "
                               f"{resumed['steps']} steps, ended at step {trainer.step}")
        for run in (first, resumed):
            if not run["metrics"] or not all(np.isfinite(v) for v in
                                             [*run["metrics"].values(), *run["val"].values()]):
                raise RuntimeError(f"non-finite DiffWave losses ({tag}): {run}")
        batches = 3 + 3  # 3 training steps, one validation batch after each of 3 epochs
        log(f"DiffWave training path ({tag}): full width, batch 16 x 62 frames, 3 steps (2, "
            f"then --resume 1) and 3 validation passes in {wall:.1f} s with set-up and "
            f"checkpoints; B1 launches {b1} ({b1 / batches:g} per batch); last losses "
            + " ".join(f"{k}={v:.4f}" for k, v in sorted(resumed["metrics"].items()))
            + f", val {resumed['val']['l1_noise']:.4f} [{card}]")
        if b1 != 2 * batches:
            raise RuntimeError(f"the DiffWave dataset ({tag}) launched B1 {b1} times for "
                               f"{batches} batches; expected 2 a batch")
        if any(p.dtype != torch.float32 for p in trainer.model.parameters()):
            raise RuntimeError(f"the DiffWave {tag} trainer holds parameters that are not f32")

    # one batch of the trainer's dataset on the card against the same batch
    # on the host (the plain rFFT path): the same crops, and both mels
    # within B1's log-mel budget
    kw = dict(segment_size=62 * HOP, hop_size=HOP, num_mels=80, sampling_rate=SR, seed=5)
    card_b = next(VocoderDataset(str(filelist), device=device, **kw).batches(16, seed=3))
    host_b = next(VocoderDataset(str(filelist), **kw).batches(16, seed=3))
    torch.testing.assert_close(card_b["audio"].cpu(), host_b["audio"], atol=0, rtol=0)
    errs = []
    for k in ("mel", "mel_loss"):
        if tuple(card_b[k].shape) != (16, 62, 80):
            raise RuntimeError(f"the DiffWave dataset's {k} has shape {tuple(card_b[k].shape)}")
        torch.testing.assert_close(card_b[k].cpu(), host_b[k], atol=1e-3, rtol=1e-4)
        errs.append((card_b[k].cpu() - host_b[k]).abs().max().item())
    log(f"DiffWave dataset, one batch of 16 x 62 frames, card (B1) vs host: the same crops; "
        f"max|mel diff| {errs[0]:.3e}, max|loss-mel diff| {errs[1]:.3e} (atol 1e-3, rtol 1e-4)")

    mels = WORK / "dw_mels"
    mels.mkdir()
    rng = np.random.default_rng(12)
    for name, frames in (("a", 150), ("b", 62)):
        np.save(mels / f"{name}.npy", rng.standard_normal((frames, 80)).astype(np.float32))
    for flags in (["--fast"], ["--fast", "--chunked"], ["--fast", "--amp"]):
        out = WORK / ("dw_wavs" + "_".join(f.strip("-") for f in flags))
        t0 = time.perf_counter()
        diffwave_infer.main(["--checkpoint", str(WORK / "dw_train_f32" / "checkpoints" / "3"),
                             "-i", str(mels), "-o", str(out)] + flags)
        torch.cuda.synchronize()
        for name, frames in (("a", 150), ("b", 62)):
            sr, audio = wavfile.read(out / f"{name}.wav")
            if sr != SR or audio.shape != (frames * HOP,) or not np.isfinite(audio).all():
                raise RuntimeError(f"diffwave_infer {flags}: {name}.wav has {audio.shape}")
        log(f"DiffWave serving path: diffwave_infer {' '.join(flags)} of 150 + 62 frames in "
            f"{time.perf_counter() - t0:.2f} s (checkpoint load included); wavs of the mels' "
            f"lengths, finite")
    return b1 // batches


def phase_diffwave_timing(torch, device, card):
    """The DiffWave train step at bench.py's shape (16 × 62 frames = 253,952
    samples, full width, Adam; f32 with TF32 off and bf16): wall (median of
    5), samples/s, the profiler split and peak memory; then the 6-step fast
    sampler at 1 × 256 frames (median of 3) and the 50-step one once."""
    from neuraltexttospeech_torch.cli.diffwave_train import make_loss_fn
    from neuraltexttospeech_torch.models.diffwave import DiffWave, DiffWaveConfig, reverse_sample
    from neuraltexttospeech_torch.nn.precision import compute_dtype
    from neuraltexttospeech_torch.train.harness import Trainer, TrainerConfig
    from neuraltexttospeech_torch.train.state import OptimizerConfig

    B, F = 16, 62
    rng = np.random.default_rng(7)
    batch = {"audio": torch.as_tensor((rng.standard_normal((B, F * HOP, 1)) * 0.1)
                                      .astype(np.float32), device=device),
             "mel": torch.as_tensor(rng.standard_normal((B, F, 80)).astype(np.float32),
                                    device=device)}
    mel = torch.as_tensor(rng.standard_normal((1, 256, 80)).astype(np.float32), device=device)
    for amp in (False, True):
        mode = "bf16 (--amp)" if amp else "f32 (TF32 off)"
        dtype = torch.bfloat16 if amp else None
        torch.manual_seed(0)
        trainer = Trainer(make_loss_fn(False), DiffWave(DiffWaveConfig()),
                          TrainerConfig(optimizer=OptimizerConfig(**DW_ADAM)), device, dtype=dtype)
        step = lambda: trainer.train_step(batch)  # noqa: E731
        wall, walls, hosts, metrics = timed_calls(torch, step, 5)
        if not all(np.isfinite(float(v)) for v in metrics.values()):
            raise RuntimeError(f"non-finite DiffWave metrics at the bench shape: {metrics}")
        log(f"DiffWave train step {mode}, full width: batch {B} x {F} frames = {B * F * HOP} "
            f"samples: wall {wall * 1e3:.1f} ms (runs {runs(walls)}; host done issuing after "
            f"{runs(hosts)}) = {B * F * HOP / wall:.0f} samples/s; peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
        log(f"  trace ({mode}): " + trace_summary(torch, step, wall))

        model = trainer.model.eval()

        def sample(fast=True):
            gen = torch.Generator(device=device).manual_seed(0)
            with compute_dtype(dtype):
                return reverse_sample(model, mel, fast_sampling=fast, generator=gen)

        wall, walls, _, audio = timed_calls(torch, sample, 3)
        n = mel.shape[1] * HOP
        if audio.shape != (1, n) or not torch.isfinite(audio).all():
            raise RuntimeError(f"the DiffWave sampler gave {tuple(audio.shape)}")
        t0 = time.perf_counter()
        sample(fast=False)
        torch.cuda.synchronize()
        slow = time.perf_counter() - t0
        log(f"DiffWave fast sampler {mode}, 6 steps, 1 x 256 frames = {n} samples: wall "
            f"{wall * 1e3:.1f} ms (runs {runs(walls)}) = {n / wall:.0f} samples/s; 50 steps "
            f"once {slow * 1e3:.1f} ms = {n / slow:.0f} samples/s [{card}]")
        log(f"  trace ({mode}, 6 steps): " + trace_summary(torch, sample, wall))
        del trainer, model


def random_gradtts(cfg, seed, device, frames_per_token, gain=0.0):
    """Random Grad-TTS (``random_init_``) whose duration head starts near
    ``frames_per_token`` frames a token, with its ReZero gains at ``gain``
    (flax initialises them to 0; the attention runs all the same). A random
    score does not pull the sampler's state back, so the state grows at
    every step; the linear attention is cubic in it, and at gains of ~1
    overflows f32 within 10 steps."""
    import torch
    from neuraltexttospeech_torch.models.gradtts import GradTTS

    model = random_init_(GradTTS(cfg).to(device), seed, device)
    with torch.no_grad():
        model.encoder.proj_w.proj.bias.fill_(float(np.log(frames_per_token)))
        for name, p in model.named_parameters():
            if name.endswith(".g"):
                p.fill_(gain)
    return model.eval()


def phase_gradtts_bench(torch, device, card):
    """Grad-TTS → HiFi-GAN v1 at full width: batch 8 × 128 interspersed random
    tokens, 10 reverse steps, ``max_mel_len`` 1000 (the duration head's bias
    set so every utterance reaches the cap), f32 (TF32 off) and bf16: wall
    (median of 3), RTF over the real frames, the profiler split."""
    from neuraltexttospeech_torch.models.gradtts import GradTTSConfig
    from neuraltexttospeech_torch.models.hifigan import Generator, HiFiGANConfig
    from neuraltexttospeech_torch.nn.precision import compute_dtype

    cfg = GradTTSConfig()
    model = random_gradtts(cfg, 3, device, frames_per_token=16.0)
    gen = random_init_(Generator(HiFiGANConfig.v1()).to(device).eval(), 4, device)
    rng = np.random.default_rng(5)
    text = np.full((8, 128), cfg.n_symbols - 1, np.int64)  # blanks between the symbols
    text[:, 1::2] = rng.integers(1, cfg.n_symbols - 1, (8, 64))
    text, lens = torch.as_tensor(text, device=device), torch.full((8,), 128, device=device)
    out = {}
    for amp in (False, True):
        mode = "bf16 (--amp)" if amp else "f32 (TF32 off)"
        dtype = torch.bfloat16 if amp else None

        def run():
            gen_ = torch.Generator(device=device).manual_seed(0)
            with torch.inference_mode(), compute_dtype(dtype):
                _, dec, _, ylen = model(text, lens, 10, max_mel_len=1000, generator=gen_)
                return ylen, gen(dec.float())

        wall, walls, _, (ylen, audio) = timed_calls(torch, run, 3)
        frames = int(ylen.sum())
        if frames != 8 * 1000 or not torch.isfinite(audio.float()).all():
            raise RuntimeError(f"gradtts2wav bench: {frames} frames, finite "
                               f"{bool(torch.isfinite(audio.float()).all())}")
        audio_s = frames * HOP / SR
        log(f"gradtts2wav {mode}: full-width Grad-TTS + HiFi-GAN v1, batch 8 x 128 tokens, "
            f"10 steps, {frames} frames = {audio_s:.3f} s audio: wall {wall:.4f} s (runs "
            f"{runs(walls)} ms) = RTF {wall / audio_s:.3e}; peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
        log(f"  trace ({mode}): " + trace_summary(torch, run, wall))
        out[mode] = wall
    return out


def check_served(what, out, max_frames=None):
    """Each of the ``SENTENCES``' served mel (``[n, 80]``, ``n > 0`` and at
    most ``max_frames``, finite) and wav (``n · 256`` finite samples at
    22.05 kHz) in ``out``; returns the frame counts."""
    from scipy.io import wavfile

    frames = []
    for j in range(len(SENTENCES)):
        mel = np.load(out / f"utt_{j:04d}_mel.npy")
        sr, audio = wavfile.read(out / f"utt_{j:04d}.wav")
        if (mel.ndim != 2 or mel.shape[1] != 80 or not 0 < mel.shape[0] <= (max_frames or np.inf)
                or not np.isfinite(mel).all() or sr != SR
                or audio.shape != (mel.shape[0] * HOP,) or not np.isfinite(audio).all()):
            raise RuntimeError(f"{what} utterance {j}: mel {mel.shape}, audio {audio.shape}")
        frames.append(mel.shape[0])
    return frames


def phase_gradtts_serve(torch, device, card):
    """The 16 ``SENTENCES`` through ``gradtts_infer.main`` with a full-width
    Grad-TTS and a HiFi-GAN v1 checkpoint (random weights), batch 8, f32 and
    ``--amp``: a mel and a wav of ``ylen · hop`` samples per sentence, finite."""
    from neuraltexttospeech_torch.cli import gradtts_infer
    from neuraltexttospeech_torch.models.gradtts import GradTTSConfig
    from neuraltexttospeech_torch.models.hifigan import Generator, HiFiGANConfig
    from neuraltexttospeech_torch.models.registry import save_checkpoint

    cfg = GradTTSConfig()
    gt_dir = save_checkpoint(WORK / "gt_serve" / "gradtts", "GradTTS", cfg,
                             random_gradtts(cfg, 6, device, frames_per_token=3.0).state_dict())
    hg_dir = save_checkpoint(WORK / "gt_serve" / "hifigan", "HiFiGAN", HiFiGANConfig.v1(),
                             random_init_(Generator(HiFiGANConfig.v1()).to(device), 7,
                                          device).state_dict())
    text_file = WORK / "gt_sentences.txt"
    text_file.write_text("\n".join(SENTENCES) + "\n")
    for tag, flags in (("f32", []), ("bf16", ["--amp"])):
        out = WORK / f"gt_serve_{tag}"
        t0 = time.perf_counter()
        gradtts_infer.main(["--checkpoint", str(gt_dir), "--hifigan-checkpoint", str(hg_dir),
                            "-i", str(text_file), "-o", str(out), "-bs", "8"] + flags)
        torch.cuda.synchronize()
        frames = sum(check_served(f"gradtts_infer ({tag})", out))
        log(f"Grad-TTS serving path ({tag}): {len(SENTENCES)} sentences, batch 8, 10 steps, "
            f"{frames} frames in {time.perf_counter() - t0:.2f} s (first calls, checkpoint "
            f"load included); mels and wavs of ylen · hop samples, finite [{card}]")


def sampled_close(what, card, cpu):
    """A sampled output card vs CPU at 1e-5 of its size (rtol 1e-5): the
    samplers multiply each step's f32 rounding (tests/test_torch_gradtts.py)."""
    card, cpu = (np.asarray(a, np.float64) for a in (card, cpu))
    np.testing.assert_allclose(card, cpu, atol=1e-5 * np.abs(cpu).max(), rtol=1e-5,
                               err_msg=what)
    return np.abs(card - cpu).max()


def diffwave_steps(torch, cfg, weights, batch, device, lr):
    """One DiffWave ``Trainer`` step (Adam at ``lr``) from ``weights`` on
    ``batch`` (numpy, with its ``t`` and ``noise``), f32 and bf16, on
    ``device`` and on the CPU: :func:`train_steps_card_and_cpu`'s record."""
    from neuraltexttospeech_torch.cli.diffwave_train import make_loss_fn
    from neuraltexttospeech_torch.models.diffwave import DiffWave

    return train_steps_card_and_cpu(torch, lambda: DiffWave(cfg), weights, make_loss_fn(False),
                                    dict(DW_ADAM, learning_rate=lr), batch, device)


def diffwave_step_inputs(torch, cfg, t, seed, rng):
    """Random DiffWave weights from ``seed`` (the output projection drawn at
    std 0.2: its zero init would hide the network from the gradients) and,
    from ``rng``, a batch of ``len(t)`` crops of ``cfg.crop_mel_frames``
    frames with the steps ``t`` and their noise."""
    from neuraltexttospeech_torch.models.diffwave import DiffWave

    torch.manual_seed(seed)
    model = DiffWave(cfg)
    torch.nn.init.normal_(model.output_projection.weight, 0.0, 0.2)
    b, n = len(t), cfg.crop_mel_frames * HOP
    batch = {"audio": (rng.standard_normal((b, n, 1)) * 0.1).astype(np.float32),
             "mel": rng.standard_normal((b, cfg.crop_mel_frames, 80)).astype(np.float32),
             "t": np.asarray(t), "noise": rng.standard_normal((b, n)).astype(np.float32)}
    return model.state_dict(), batch


def phase_diffwave_reference(torch, device):
    """A small DiffWave (6 layers × 16 channels, batch 3 × 8 frames): one
    Trainer step card vs CPU from the same weights, steps and noise, at the
    trainer tolerances (metrics rtol 2e-4, parameters rtol 3e-3 / atol 3e-5),
    and a 6-step sample with the same start and noise at 1e-5 of its size;
    then both in bf16, by :func:`check_bf16_step` and the yardstick."""
    from neuraltexttospeech_torch.models.diffwave import DiffWave, DiffWaveConfig, reverse_sample
    from neuraltexttospeech_torch.nn.precision import compute_dtype

    cfg = DiffWaveConfig(residual_layers=6, residual_channels=16, crop_mel_frames=8)
    rng = np.random.default_rng(9)
    weights, batch = diffwave_step_inputs(torch, cfg, [2, 25, 47], 2, rng)
    audio0 = rng.standard_normal((3, 8 * HOP)).astype(np.float32)
    noise = rng.standard_normal((6, 3, 8 * HOP)).astype(np.float32)
    steps = diffwave_steps(torch, cfg, weights, batch, device, 1e-3)
    samples = {}
    for amp in (False, True):
        for dev in (device, torch.device("cpu")):
            m = DiffWave(cfg).to(dev)
            m.load_state_dict(weights)
            with compute_dtype(torch.bfloat16 if amp else None):
                samples[(amp, dev.type)] = reverse_sample(
                    m.eval(), torch.as_tensor(batch["mel"], device=dev), fast_sampling=True,
                    audio0=torch.as_tensor(audio0, device=dev),
                    noise=[torch.as_tensor(z, device=dev) for z in noise]).cpu().numpy()
    check_f32_step("small DiffWave train step", steps)
    d = sampled_close("DiffWave 6-step sample", samples[(False, "cuda")], samples[(False, "cpu")])
    log(f"reference: small DiffWave 6-step sample card vs CPU: max|diff| {d:.2e}")
    check_bf16_step("small DiffWave train step", *({k: v[i] for k, v in steps.items()}
                                                   for i in range(3)), 1e-3)
    e = bf16_yardstick("DiffWave 6-step sample", samples[(True, "cuda")],
                       samples[(True, "cpu")], samples[(False, "cpu")])
    log(f"reference: small DiffWave 6-step sample bf16 card vs CPU {e[0]:.2e}, CPU bf16 vs "
        f"f32 {e[1]:.2e}")


def phase_gradtts_reference(torch, device):
    """A small Grad-TTS (the goldens' widths, the english_basic symbol set):
    synthesis with the same noise and 2 steps card vs CPU: the same lengths
    and alignment, the encoder's mel within 1e-4 (as text → wav's check) and
    the decoder's within 1e-5 of its size (the ReZero gains at 0.005: at
    0.02 these random weights make the mel so ill-conditioned that a 1e-7
    relative change of the weights moves it by 3e-3, past that bound);
    then bf16: the encoder and the sampler (from the f32 prior) by the
    yardstick, and the synthesis's lengths."""
    from neuraltexttospeech_torch.models.gradtts import GradTTSConfig
    from neuraltexttospeech_torch.nn.precision import compute_dtype

    cfg = GradTTSConfig(n_enc_channels=32, filter_channels=64, filter_channels_dp=32,
                        n_enc_layers=2, dec_dim=8)
    weights = random_gradtts(cfg, 11, torch.device("cpu"), 2.0, gain=0.005).state_dict()
    rng = np.random.default_rng(13)
    x = rng.integers(1, cfg.n_symbols - 1, (3, 24))
    xl = np.asarray([24, 17, 9])
    noise = rng.standard_normal((3, 80, 64)).astype(np.float32)
    cpu = torch.device("cpu")
    res = {}
    for dev in (device, cpu):
        model = random_gradtts(cfg, 11, dev, 2.0)
        model.load_state_dict(weights)
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        f32 = model(t(x), t(xl), 2, max_mel_len=64, noise=t(noise))
        mu = f32[0].transpose(1, 2)
        mask = torch.arange(64, device=dev)[None] < f32[3][:, None]
        with torch.no_grad(), compute_dtype(torch.bfloat16):
            enc = model.encoder(t(x), t(xl))[:2]
            dec = model.decoder.reverse_diffusion(mu + t(noise), mask, mu, 2)
            full = model(t(x), t(xl), 2, max_mel_len=64, noise=t(noise))
        res[dev.type] = ([a.cpu() for a in f32], [a.float().cpu() for a in enc], dec.cpu(),
                         full[3].cpu())
    (gf, ge, gd, gl), (cf, ce, cd, cl) = res["cuda"], res["cpu"]
    np.testing.assert_array_equal(gf[3].numpy(), cf[3].numpy())  # lengths
    np.testing.assert_array_equal(gf[2].numpy(), cf[2].numpy())  # alignment
    np.testing.assert_allclose(gf[0].numpy(), cf[0].numpy(), atol=1e-4, rtol=0, err_msg="enc")
    d = sampled_close("Grad-TTS synthesis dec", gf[1], cf[1])
    # the CPU's own bf16 error, against its f32 run from the same inputs
    with torch.no_grad():
        model = random_gradtts(cfg, 11, cpu, 2.0)
        model.load_state_dict(weights)
        enc32 = model.encoder(torch.as_tensor(x), torch.as_tensor(xl))[:2]
        mu = cf[0].transpose(1, 2)
        mask = torch.arange(64)[None] < cf[3][:, None]
        dec32 = model.decoder.reverse_diffusion(mu + torch.as_tensor(noise), mask, mu, 2)
    e = [bf16_yardstick(f"Grad-TTS encoder {n}", g, c, f) for n, g, c, f in
         zip(("mu_x", "logw"), ge, ce, enc32)]
    e.append(bf16_yardstick("Grad-TTS sampler", gd, cd, dec32))
    log(f"reference: small Grad-TTS synthesis card vs CPU: max|enc diff| "
        f"{(gf[0] - cf[0]).abs().max().item():.2e}, max|dec diff| {d:.2e} (max |dec| "
        f"{cf[1].abs().max().item():.2f}), equal lengths; bf16 card vs CPU (|card - CPU|, CPU "
        f"bf16 vs f32): mu_x {e[0][0]:.2e}/{e[0][1]:.2e}, logw {e[1][0]:.2e}/{e[1][1]:.2e}, "
        f"sampler {e[2][0]:.2e}/{e[2][1]:.2e}; bf16 lengths card {gl.tolist()}, CPU "
        f"{cl.tolist()}")


# gradtts/train.py's Adam; fastspeech2/train.py's noam Adam
GT_ADAM = dict(learning_rate=1e-4, grad_clip_norm=1.0, beta1=0.9, beta2=0.999, eps=1e-8)
FS2_NOAM = dict(learning_rate=1e-3, schedule="noam", warmup_steps=4000, grad_clip_norm=1.0,
                beta1=0.9, beta2=0.98, eps=1e-9)
# ARPAbet phones the synthetic TextGrids cycle through
PHONES = ("HH", "AH0", "L", "OW1", "W", "ER1", "D", "DH", "IH0", "S", "T", "EY1", "N", "K",
          "AE1", "M", "P", "IY1", "R", "Z")


def gradtts_batch(rng, batch, t_text, t_mel, n_symbols, text_lens, mel_lens, out_size=None):
    """A random Grad-TTS batch (numpy): interspersed random tokens (the blank
    ``n_symbols − 1`` at the even places) and N(0, 1) mels, zero past their
    lengths; with ``out_size`` also the loss's draws (the cut's ``u``, the
    time ``t`` and the noise ``z``), so that two devices see the same ones."""
    text_lens, mel_lens = np.asarray(text_lens, np.int32), np.asarray(mel_lens, np.int32)
    text = np.full((batch, t_text), n_symbols - 1, np.int32)
    text[:, 1::2] = rng.integers(1, n_symbols - 1, (batch, t_text // 2))
    text[np.arange(t_text)[None] >= text_lens[:, None]] = 0
    valid = np.arange(t_mel)[None, :, None] < mel_lens[:, None, None]
    out = {"text": text, "input_lens": text_lens, "mel_lens": mel_lens,
           "mel": (rng.standard_normal((batch, t_mel, 80)) * valid).astype(np.float32)}
    if out_size is not None:
        out["u"] = rng.uniform(size=batch).astype(np.float32)
        out["t"] = rng.uniform(1e-5, 1.0 - 1e-5, batch).astype(np.float32)
        out["z"] = rng.standard_normal((batch, 80, min(out_size, t_mel))).astype(np.float32)
    return out


def fastspeech2_batch(rng, batch, t_text, t_mel, n_symbols, text_lens, frames_per_token):
    """A random FastSpeech 2 batch (numpy): tokens, ``frames_per_token``
    frames each, N(0, 1) mels, normalized pitch and energy."""
    text_lens = np.asarray(text_lens, np.int32)
    valid = np.arange(t_text)[None] < text_lens[:, None]
    text = np.where(valid, rng.integers(1, n_symbols, (batch, t_text)), 0).astype(np.int32)
    dur = (valid * frames_per_token).astype(np.float32)
    mel_lens = dur.sum(1).astype(np.int32)
    frame_ok = np.arange(t_mel)[None, :, None] < mel_lens[:, None, None]
    return {"text": text, "input_lens": text_lens, "mel_lens": mel_lens, "dur": dur,
            "mel": (rng.standard_normal((batch, t_mel, 80)) * frame_ok).astype(np.float32),
            "pitch": (rng.standard_normal((batch, t_text)) * valid).astype(np.float32),
            "energy": (rng.standard_normal((batch, t_text)) * valid).astype(np.float32)}


def phase_gradtts_train_cli(torch, device, card):
    """Grad-TTS training through its CLI at full width: ``gradtts_train`` on
    the 16 synthetic wavs of the FastPitch phase (their mels are that phase's
    B1 log-mels, read from its feature directory), batch 16, validation on
    the same list, 2 steps then ``--resume`` for a 3rd, f32 and ``--amp``;
    MAS once a step and once a validation batch. Then ``gradtts_infer`` serves
    the 16 sentences from the trained f32 checkpoint with the HiFi-GAN v1
    checkpoint of the serving phase. Returns MAS's launches per step."""
    from neuraltexttospeech_torch.cli import gradtts_infer, gradtts_train
    from neuraltexttospeech_torch.ops import gouter_kernel, mas_kernel, mel_kernel

    filelist, feats = WORK / "fp_train.txt", WORK / "fp_feats"
    out = {}
    for tag, flags in (("f32", []), ("bf16", ["--amp"])):
        run_dir = WORK / f"gt_train_{tag}"
        args = ["-o", str(run_dir), "-d", str(feats), "--training-files", str(filelist),
                "--validation-files", str(filelist), "-bs", "16", "--steps-per-epoch", "1"] + flags
        for counted in counted_kernels():
            counted.launches = 0
        t0 = time.perf_counter()
        first = gradtts_train.main(args + ["--epochs", "2"])
        resumed = gradtts_train.main(args + ["--epochs", "3", "--resume"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        mas = mas_kernel.maximum_path.launches
        b1 = mel_kernel.fused_frames_to_mel.launches
        b2 = gouter_kernel.gouter_tap_dots_kernel.launches
        trainer = resumed["trainer"]
        dtype = torch.bfloat16 if flags else None
        if (first["steps"], resumed["steps"], trainer.step, trainer.dtype) != (2, 1, 3, dtype):
            raise RuntimeError(f"Grad-TTS trainer ({tag}) ran {first['steps']} + "
                               f"{resumed['steps']} steps, ended at step {trainer.step}")
        for run in (first, resumed):
            values = [*run["metrics"].values(), *run["val"].values()]
            if not run["metrics"] or not run["val"] or not all(np.isfinite(v) for v in values):
                raise RuntimeError(f"non-finite or missing Grad-TTS losses ({tag}): {run}")
        steps, val_batches = 3, 3  # one validation batch (16 utterances) after each epoch
        log(f"Grad-TTS training path ({tag}): full width, batch 16, {steps} steps (2, then "
            f"--resume 1) and {val_batches} validation passes in {wall:.1f} s with set-up and "
            f"checkpoints; MAS launches {mas} (1 a step and 1 a validation batch), B1 {b1}, "
            f"B2 {b2}; last losses "
            + " ".join(f"{k}={v:.4f}" for k, v in sorted(resumed["metrics"].items()))
            + f" [{card}]")
        if mas != steps + val_batches or b1 or b2:
            raise RuntimeError(f"the Grad-TTS step ({tag}) launched MAS {mas}, B1 {b1}, B2 {b2} "
                               f"times in {steps} steps and {val_batches} validation batches; "
                               f"expected {steps + val_batches}, 0, 0")
        if any(p.dtype != torch.float32 for p in trainer.model.parameters()):
            raise RuntimeError(f"the Grad-TTS {tag} trainer holds parameters that are not f32")
        out[tag] = {"mas": mas, "mas_per_step": (mas - val_batches) // steps}
        del trainer, first, resumed

    served = WORK / "gt_trained_serve"
    t0 = time.perf_counter()
    gradtts_infer.main(["--checkpoint", str(WORK / "gt_train_f32" / "checkpoints" / "3"),
                        "--hifigan-checkpoint", str(WORK / "gt_serve" / "hifigan"), "-i",
                        str(WORK / "gt_sentences.txt"), "-o", str(served), "-bs", "8"])
    torch.cuda.synchronize()
    frames = sum(check_served("gradtts_infer from the trained checkpoint", served))
    log(f"Grad-TTS serving from the trained checkpoint: {len(SENTENCES)} sentences, {frames} "
        f"frames in {time.perf_counter() - t0:.2f} s (first call, checkpoint load included); "
        f"mels and wavs of ylen · hop samples, finite [{card}]")
    return out


def textgrid(intervals, xmax):
    """A one-tier ("phones") long-form TextGrid, as MFA writes them."""
    items = "\n".join(f"        intervals [{i + 1}]:\n            xmin = {s}\n"
                      f"            xmax = {e}\n            text = \"{p}\""
                      for i, (s, e, p) in enumerate(intervals))
    return ("File type = \"ooTextFile\"\nObject class = \"TextGrid\"\n\nxmin = 0\n"
            f"xmax = {xmax}\ntiers? <exists>\nsize = 1\nitem []:\n    item [1]:\n"
            "        class = \"IntervalTier\"\n        name = \"phones\"\n        xmin = 0\n"
            f"        xmax = {xmax}\n        intervals: size = {len(intervals)}\n{items}\n")


def phase_fastspeech2_cli(torch, device, card):
    """FastSpeech 2 through its CLIs at full width: synthetic TextGrids (0.1 s
    of leading "sil", about ten ARPAbet phones a second, 0.1 s of trailing
    "sp") for the 16 wavs of the FastPitch phase → ``fastspeech2_prepare_dataset``
    on the card (B1 once a wav; each utterance's log-mel held against the
    host's plain path and against B1's twin) → ``fastspeech2_train`` on the 12
    training utterances (batch 12, validation on the 4 held out), 2 steps then
    ``--resume`` for a 3rd, f32 and ``--amp`` → ``fastspeech2_infer`` of the 16
    sentences with the serving phase's HiFi-GAN v1, f32 and ``--amp``: finite
    wavs of ``dec_lens · 256`` samples. Returns B1's launches in prep."""
    from neuraltexttospeech_torch.audio.stft import STFTConfig, windowed_frames
    from neuraltexttospeech_torch.cli import (fastspeech2_infer, fastspeech2_prepare_dataset,
                                              fastspeech2_train)
    from neuraltexttospeech_torch.data.filelist import load_wav
    from neuraltexttospeech_torch.data.fs2_preprocess import FS2Preprocessor
    from neuraltexttospeech_torch.data.textgrid import parse_textgrid
    from neuraltexttospeech_torch.models.registry import load_checkpoint, save_checkpoint
    from neuraltexttospeech_torch.ops import gouter_kernel, mas_kernel, mel_kernel

    raw, tg, pre = WORK / "fs2_raw", WORK / "fs2_tg", WORK / "fs2_pre"
    raw.mkdir()
    tg.mkdir()
    meta, names = [], []
    for i, line in enumerate((WORK / "fp_train.txt").read_text().splitlines()):
        path, text = line.split("|", 1)
        seconds = load_wav(path, SR)[0].size / SR
        name = f"LJ{i:03d}"
        shutil.copy(path, raw / f"{name}.wav")
        edges = np.round(np.linspace(0.1, seconds - 0.1, max(8, int(seconds * 10)) + 1), 4)
        ivs = ([(0.0, 0.1, "sil")]
               + [(a, b, PHONES[(i + j) % len(PHONES)])
                  for j, (a, b) in enumerate(zip(edges[:-1], edges[1:]))]
               + [(float(edges[-1]), round(seconds, 4), "sp")])
        (tg / f"{name}.TextGrid").write_text(textgrid(ivs, round(seconds, 4)))
        meta.append(f"{name}|{text}|{text}")
        names.append(name)
    (raw / "metadata.csv").write_text("\n".join(meta) + "\n")

    mel_kernel.fused_frames_to_mel.launches = 0
    t0 = time.perf_counter()
    stats = fastspeech2_prepare_dataset.main(["--raw-path", str(raw), "--textgrid-path",
                                              str(tg), "--out-dir", str(pre), "--val-size", "4"])
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    b1_prep = mel_kernel.fused_frames_to_mel.launches
    if b1_prep != len(names):
        raise RuntimeError(f"FastSpeech 2 prep launched B1 {b1_prep} times for {len(names)} wavs")
    # B1 at the prep's call sites: each utterance's saved (card) log-mel
    # against the host's plain path on the same samples, and B1 against its
    # twin on the card on that utterance's frames
    host = FS2Preprocessor(str(raw), str(tg), str(WORK / "fs2_host"), device="cpu")
    cfg, d_host, d_twin, n_frames = STFTConfig(), 0.0, 0.0, 0
    for name in names:
        tiers = parse_textgrid(str(tg / f"{name}.TextGrid"))
        _, _, start, end = host.get_alignment(tiers["phones"])
        a = load_wav(str(raw / f"{name}.wav"), SR)[0][int(SR * start):int(SR * end)]
        saved = np.load(pre / f"{name}_mel.npy")
        want = host.stft.mel_spectrogram(a).numpy()[:saved.shape[0]]
        np.testing.assert_allclose(saved, want, atol=1e-3, rtol=1e-4, err_msg=name)
        d_host = max(d_host, float(np.abs(saved - want).max()))
        frames = windowed_frames(torch.as_tensor(a, device=device), 1024, HOP, 1024).contiguous()
        got, twin = (mel_kernel.fused_frames_to_mel(frames, cfg),
                     mel_kernel.frames_to_mel_reference(frames, cfg))
        torch.testing.assert_close(got, twin, atol=1e-3, rtol=1e-4)
        d_twin = max(d_twin, (got - twin).abs().max().item())
        n_frames += frames.shape[0]
    log(f"FastSpeech 2 prep path: {len(names)} wavs ({n_frames} frames) in {prep_s:.2f} s (pitch "
        f"on the host); B1 launches {b1_prep}; saved log-mels vs the host's plain path max|diff| "
        f"{d_host:.3e}, B1 vs its twin on the card {d_twin:.3e} (atol 1e-3, rtol 1e-4); "
        f"pitch range [{stats['pitch_min']:.2f}, {stats['pitch_max']:.2f}] [{card}]")

    for tag, flags in (("f32", []), ("bf16", ["--amp"])):
        run_dir = WORK / f"fs2_train_{tag}"
        args = ["-o", str(run_dir), "-d", str(pre), "--validation-split", "val", "-bs", "12",
                "--steps-per-epoch", "1"] + flags
        for counted in counted_kernels():
            counted.launches = 0
        t0 = time.perf_counter()
        first = fastspeech2_train.main(args + ["--epochs", "2"])
        resumed = fastspeech2_train.main(args + ["--epochs", "3", "--resume"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = (mel_kernel.fused_frames_to_mel.launches,
                  gouter_kernel.gouter_tap_dots_kernel.launches, mas_kernel.maximum_path.launches)
        trainer = resumed["trainer"]
        dtype = torch.bfloat16 if flags else None
        if (first["steps"], resumed["steps"], trainer.step, trainer.dtype) != (2, 1, 3, dtype):
            raise RuntimeError(f"FastSpeech 2 trainer ({tag}) ran {first['steps']} + "
                               f"{resumed['steps']} steps, ended at step {trainer.step}")
        for run in (first, resumed):
            values = [*run["metrics"].values(), *run["val"].values()]
            if not run["metrics"] or not run["val"] or not all(np.isfinite(v) for v in values):
                raise RuntimeError(f"non-finite or missing FastSpeech 2 losses ({tag}): {run}")
        if any(counts) or any(p.dtype != torch.float32 for p in trainer.model.parameters()):
            raise RuntimeError(f"the FastSpeech 2 step ({tag}) launched B1, B2, MAS {counts} "
                               f"times (expected none) or holds parameters that are not f32")
        log(f"FastSpeech 2 training path ({tag}): full width, batch 12, 3 steps (2, then --resume "
            f"1) and 3 validation passes in {wall:.1f} s with set-up and checkpoints; last losses "
            + " ".join(f"{k}={v:.4f}" for k, v in sorted(resumed["metrics"].items()))
            + f" [{card}]")
        del trainer, first, resumed

    # serving: the trained f32 checkpoint, its duration head's bias set to
    # log 7 (3 steps of a noam warm-up leave it at ~0: zero-length outputs)
    model, config = load_checkpoint(WORK / "fs2_train_f32" / "checkpoints" / "3", "FastSpeech2",
                                    device)
    with torch.no_grad():
        model.duration_predictor.fc.bias.fill_(float(np.log(7.0)))
    fe = json.loads((WORK / "fs2_train_f32" / "checkpoints" / "3" / "model_config.json")
                    .read_text())["frontend"]
    ckpt = save_checkpoint(WORK / "fs2_serve", "FastSpeech2", config, model.state_dict(), fe)
    for tag, flags in (("f32", []), ("bf16", ["--amp"])):
        out = WORK / f"fs2_wavs_{tag}"
        t0 = time.perf_counter()
        fastspeech2_infer.main(["--checkpoint", str(ckpt), "--hifigan-checkpoint",
                                str(WORK / "gt_serve" / "hifigan"), "-i",
                                str(WORK / "gt_sentences.txt"), "-o", str(out), "-bs", "8"]
                               + flags)
        torch.cuda.synchronize()
        frames = sum(check_served(f"fastspeech2_infer ({tag})", out))
        log(f"FastSpeech 2 serving path ({tag}): {len(SENTENCES)} sentences, batch 8, {frames} "
            f"frames in {time.perf_counter() - t0:.2f} s (first call, checkpoint load "
            f"included); mels and wavs of dec_lens · hop samples, finite [{card}]")
    return b1_prep


def train_steps_card_and_cpu(torch, make_model, weights, loss_fn, opt, batch, device,
                             amps=(False, True), model_amp=False):
    """One ``Trainer`` step from ``weights`` on ``batch`` (numpy), f32 and
    bf16 (``amps``), on ``device`` and on the CPU: {(amp, device type):
    (metrics, parameters, gradients)}, the gradients from Adam's first
    moment. With ``model_amp`` the model takes bf16 from its own config
    (``make_model(amp)``, TalkNet 2's heads) and the trainer sets no compute
    dtype."""
    from neuraltexttospeech_torch.train.harness import Trainer, TrainerConfig
    from neuraltexttospeech_torch.train.state import OptimizerConfig

    steps = {}
    for amp in amps:
        for dev in (device, torch.device("cpu")):
            m = make_model(amp) if model_amp else make_model()
            m.load_state_dict(weights)
            trainer = Trainer(loss_fn, m, TrainerConfig(optimizer=OptimizerConfig(**opt)), dev,
                              dtype=torch.bfloat16 if amp and not model_amp else None)
            metrics = trainer.train_step({k: torch.as_tensor(v, device=dev)
                                          for k, v in batch.items()})
            # the first Adam moment after one step is (1 - b1) g
            b1 = trainer.optimizer.config.beta1
            names = [n for n, p in m.named_parameters() if p.requires_grad]
            steps[(amp, dev.type)] = (
                {k: float(v) for k, v in metrics.items()},
                {k: v.detach().cpu().clone() for k, v in m.state_dict().items()},
                {n: (mu / (1.0 - b1)).cpu() for n, mu in zip(names, trainer.optimizer.mu)})
            del trainer, m
    return steps


def check_f32_step(label, steps):
    """Card vs CPU f32 step at the trainer tolerances (metrics rtol 2e-4,
    parameters rtol 3e-3 / atol 3e-5); logs the largest differences."""
    card, cpu = steps[(False, "cuda")], steps[(False, "cpu")]
    for k, v in cpu[0].items():
        np.testing.assert_allclose(card[0][k], v, rtol=2e-4, err_msg=f"{label} {k}")
    worst_p = 0.0
    for k, v in cpu[1].items():
        np.testing.assert_allclose(card[1][k].numpy(), v.numpy(), rtol=3e-3, atol=3e-5,
                                   err_msg=f"{label} {k}")
        worst_p = max(worst_p, (card[1][k] - v).abs().max().item())
    worst_m = max(abs(card[0][k] - v) / max(abs(v), 1e-12) for k, v in cpu[0].items())
    log(f"reference: {label} card vs CPU: max relative metric diff {worst_m:.2e}, max|param "
        f"diff| {worst_p:.2e}")


def phase_gradtts_train_reference(torch, device):
    """One Grad-TTS train step of a small Grad-TTS (the goldens' widths, the
    UNet at 16 so that each GroupNorm group holds two channels, the
    english_basic symbol set, dropout off), batch 3 × 24 interspersed tokens
    × 64 frames, ``out_size`` 32, the loss's draws in the batch: card vs CPU
    from the same weights (``random_gradtts``'s scaled init, ReZero gains at
    0.02) at the trainer tolerances, Adam at lr 1e-3 with eps 1e-6 (as the
    FastPitch reference: the attention's key bias has a gradient that is
    zero but for rounding); the MAS paths of both devices' log-priors equal;
    then bf16 by :func:`check_bf16_step`."""
    from neuraltexttospeech_torch.cli.gradtts_train import make_loss_fn
    from neuraltexttospeech_torch.models.gradtts import GradTTS, GradTTSConfig, gaussian_log_prior
    from neuraltexttospeech_torch.ops.mas import maximum_path

    cfg = GradTTSConfig(n_enc_channels=32, filter_channels=64, filter_channels_dp=32,
                        n_enc_layers=2, dec_dim=16, enc_dropout=0.0)
    cpu = torch.device("cpu")
    weights = {k: v.clone() for k, v in
               random_gradtts(cfg, 21, cpu, 2.0, gain=0.02).state_dict().items()}

    def make_model():
        m = GradTTS(cfg)
        m.encoder.prenet.p_dropout = m.encoder.proj_w.p_dropout = 0.0
        return m

    batch = gradtts_batch(np.random.default_rng(22), 3, 24, 64, cfg.n_symbols, [24, 17, 11],
                          [64, 51, 30], out_size=32)
    paths = {}
    for dev in (device, cpu):
        m = make_model().to(dev)
        m.load_state_dict(weights)
        t = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        with torch.no_grad():
            mu_x = m.encoder(t["text"], t["input_lens"])[0]
            paths[dev.type] = maximum_path(gaussian_log_prior(mu_x, t["mel"]).transpose(1, 2),
                                           t["input_lens"], t["mel_lens"]).cpu()
    if not torch.equal(paths["cuda"], paths["cpu"]):
        raise RuntimeError(f"Grad-TTS MAS paths differ card vs CPU at "
                           f"{int((paths['cuda'] != paths['cpu']).sum())} cells (a near-tie)")
    opt = dict(learning_rate=1e-3, beta1=0.9, beta2=0.999, eps=1e-6, grad_clip_norm=1.0)
    steps = train_steps_card_and_cpu(torch, make_model, weights, make_loss_fn(32), opt, batch,
                                     device)
    log("reference: small Grad-TTS step: the MAS paths of the card's and the CPU's log-priors "
        "are equal")
    check_f32_step("small Grad-TTS train step", steps)
    check_bf16_step("small Grad-TTS train step", *({k: v[i] for k, v in steps.items()}
                                                   for i in range(3)), opt["learning_rate"])


def phase_fastspeech2_reference(torch, device):
    """One FastSpeech 2 train step of tests/test_fastspeech2.py's TINY (148
    symbols, dropout off), batch 3 × 16 tokens × 48 frames, the noam schedule
    with warm-up 4 and Adam eps 1e-6 (tests/test_torch_fastspeech2.py's): card
    vs CPU from the same weights at the trainer tolerances, then bf16 by
    :func:`check_bf16_step`."""
    from neuraltexttospeech_torch.cli.fastspeech2_train import loss_fn
    from neuraltexttospeech_torch.models.fastspeech2 import FastSpeech2, FastSpeech2Config

    cfg = FastSpeech2Config(encoder_layer=1, decoder_layer=1, encoder_hidden=32,
                            decoder_hidden=32, conv_filter_size=64, variance_filter_size=16,
                            n_bins=16, postnet_dim=24, postnet_layers=2, encoder_dropout=0.0,
                            decoder_dropout=0.0, variance_dropout=0.0)

    def make_model():
        m = FastSpeech2(cfg)
        m.postnet.p_dropout = 0.0
        return m

    torch.manual_seed(23)
    weights = {k: v.clone() for k, v in make_model().state_dict().items()}
    batch = fastspeech2_batch(np.random.default_rng(24), 3, 16, 48, 148, [16, 11, 7], 3)
    opt = dict(learning_rate=1e-3, schedule="noam", warmup_steps=4, grad_clip_norm=1.0,
               beta1=0.9, beta2=0.98, eps=1e-6)
    steps = train_steps_card_and_cpu(torch, make_model, weights, loss_fn, opt, batch, device)
    check_f32_step("small FastSpeech 2 train step", steps)
    check_bf16_step("small FastSpeech 2 train step", *({k: v[i] for k, v in steps.items()}
                                                       for i in range(3)), 2.5e-4)


def step_timing(torch, trainer, batch, label, card, frames, kernel=None, unit="mel frames"):
    """A train step's wall (median of 5 synchronised steps after 2 warm
    ones), steps/s and ``frames`` ``unit``/s, peak memory, then one traced step:
    busy time, idle share, device events, host launches, the top kernels and
    ``kernel``'s time and share."""
    for _ in range(2):
        trainer.train_step(batch)
    wall, walls, hosts, metrics = timed_calls(torch, lambda: trainer.train_step(batch), 5)
    if not all(np.isfinite(float(v)) for v in metrics.values()):
        raise RuntimeError(f"non-finite {label} metrics: {metrics}")
    log(f"{label}: wall {wall * 1e3:.1f} ms (runs {runs(walls)}; host done issuing after "
        f"{runs(hosts)}) = {1 / wall:.2f} steps/s, {frames / wall:.0f} {unit}/s; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    summary = trace_summary(torch, lambda: trainer.train_step(batch), wall)
    extra = ""
    if kernel is not None:
        ms = sum(t for t, name in device_breakdown.last if kernel in name)
        n = sum(c for name, c in device_breakdown.counts.items() if kernel in name)
        extra = (f"; {kernel} {n} launch(es), {ms:.3f} ms "
                 f"({ms / device_breakdown.kernel_sum:.2%} of kernel time)")
    log(f"  trace: {summary}{extra}")
    return wall


def phase_gradtts_train_timing(torch, device, card, amp=False):
    """The Grad-TTS train step at bench.py's shape (16 × 160 interspersed
    tokens × 512 frames, full lengths, ``out_size`` 172, full width, dropout
    on, gradtts/train.py's Adam; f32 with TF32 off, or bf16): wall, steps/s,
    the profiler split with MAS's share, peak memory."""
    from neuraltexttospeech_torch.cli.gradtts_train import make_loss_fn
    from neuraltexttospeech_torch.models.gradtts import GradTTSConfig
    from neuraltexttospeech_torch.train.harness import Trainer, TrainerConfig
    from neuraltexttospeech_torch.train.state import OptimizerConfig

    B, T_TEXT, T_MEL = 16, 160, 512
    cfg = GradTTSConfig()
    model = random_gradtts(cfg, 31, device, frames_per_token=3.2, gain=0.02)
    trainer = Trainer(make_loss_fn(cfg.out_size), model,
                      TrainerConfig(optimizer=OptimizerConfig(**GT_ADAM)), device,
                      dtype=torch.bfloat16 if amp else None)
    batch = {k: torch.as_tensor(v, device=device) for k, v in gradtts_batch(
        np.random.default_rng(32), B, T_TEXT, T_MEL, cfg.n_symbols, [T_TEXT] * B,
        [T_MEL] * B).items()}
    mode = "bf16 (--amp)" if amp else "f32 (TF32 off)"
    step_timing(torch, trainer, batch, f"Grad-TTS train step {mode}, full width, dropout on: "
                f"batch {B} x {T_TEXT} tokens x {T_MEL} frames, out_size {cfg.out_size}",
                card, B * T_MEL, kernel="mas_kernel")
    del trainer, model


def phase_fastspeech2_train_timing(torch, device, card, amp=False):
    """The FastSpeech 2 train step at bench.py's shape (16 × 128 tokens × 768
    frames, 6 frames a token, full width, dropout on, fastspeech2/train.py's
    noam Adam; f32 with TF32 off, or bf16): wall, steps/s, the profiler
    split, peak memory."""
    from neuraltexttospeech_torch.cli.fastspeech2_train import loss_fn
    from neuraltexttospeech_torch.models.fastspeech2 import FastSpeech2, FastSpeech2Config
    from neuraltexttospeech_torch.train.harness import Trainer, TrainerConfig
    from neuraltexttospeech_torch.train.state import OptimizerConfig

    B, T_TEXT, T_MEL = 16, 128, 768
    torch.manual_seed(0)
    trainer = Trainer(loss_fn, FastSpeech2(FastSpeech2Config()),
                      TrainerConfig(optimizer=OptimizerConfig(**FS2_NOAM)), device,
                      dtype=torch.bfloat16 if amp else None)
    batch = {k: torch.as_tensor(v, device=device) for k, v in fastspeech2_batch(
        np.random.default_rng(33), B, T_TEXT, T_MEL, 148, [T_TEXT] * B, T_MEL // T_TEXT).items()}
    mode = "bf16 (--amp)" if amp else "f32 (TF32 off)"
    step_timing(torch, trainer, batch, f"FastSpeech 2 train step {mode}, full width, dropout on: "
                f"batch {B} x {T_TEXT} tokens x {T_MEL} frames", card, B * T_MEL)
    del trainer


TN_ADAM = dict(learning_rate=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, grad_clip_norm=1.0)


def b1_against_twin(torch, device, wav_paths):
    """B1 against its twin on the card on each wav's frames (atol 1e-3, rtol
    1e-4): (max|diff|, frames)."""
    from neuraltexttospeech_torch.audio.stft import STFTConfig, windowed_frames
    from neuraltexttospeech_torch.data.filelist import load_wav
    from neuraltexttospeech_torch.ops import mel_kernel

    cfg, d_twin, n_frames = STFTConfig(), 0.0, 0
    for path in wav_paths:
        audio = torch.as_tensor(load_wav(path, SR)[0], device=device)
        frames = windowed_frames(audio, 1024, HOP, 1024).contiguous()
        got, twin = (mel_kernel.fused_frames_to_mel(frames, cfg),
                     mel_kernel.frames_to_mel_reference(frames, cfg))
        torch.testing.assert_close(got, twin, atol=1e-3, rtol=1e-4)
        d_twin, n_frames = max(d_twin, (got - twin).abs().max().item()), n_frames + len(frames)
    return d_twin, n_frames


def phase_talknet_cli(torch, device, card):
    """TalkNet 2 through its CLIs at full width. The ASR (QuartzNet 5×5) on
    the FastPitch phase's 16 synthetic wavs with their ``SENTENCES``
    transcripts, batch 16, 2 steps then ``--resume`` for a 3rd: the dataset
    computes each utterance's log-mel on the card (B1 once an utterance an
    epoch, counted), and B1 there is held against its twin (atol 1e-3, rtol
    1e-4) on each utterance's frames, and a card batch against the host's.
    The duration, pitch and spectrogram heads on the FastSpeech 2 phase's
    prepared corpus (batch 12), f32 and ``--amp``, 2 steps then
    ``--resume`` for a 3rd; then ``talknet_infer`` of the 16 sentences with
    the serving phase's HiFi-GAN v1, f32 and ``--amp``: finite wavs of
    ``n · 256`` samples. Returns B1's ASR launches."""
    from neuraltexttospeech_torch.cli import talknet_infer, talknet_train
    from neuraltexttospeech_torch.data.asr_dataset import ASRDataset
    from neuraltexttospeech_torch.models.registry import load_checkpoint, save_checkpoint
    from neuraltexttospeech_torch.models.talknet import GraphemeDuration

    counted = counted_kernels()

    def run_cli(tag, argv, expect_dtype):
        for fn in counted:
            fn.launches = 0
        t0 = time.perf_counter()
        first = talknet_train.main(argv + ["--epochs", "2"])
        resumed = talknet_train.main(argv + ["--epochs", "3", "--resume"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        trainer = resumed["trainer"]
        dtype = getattr(resumed["config"], "dtype", None)  # QuartzNetConfig has none: f32
        if (first["steps"], resumed["steps"], trainer.step, dtype) != (2, 1, 3, expect_dtype):
            raise RuntimeError(f"TalkNet 2 {tag}: {first['steps']} + {resumed['steps']} steps, "
                               f"step {trainer.step}, dtype {dtype}")
        state = trainer.model.state_dict()
        for run in (first, resumed):
            if not run["metrics"] or not all(np.isfinite(v) for v in run["metrics"].values()):
                raise RuntimeError(f"non-finite or missing TalkNet 2 {tag} metrics: {run}")
        if any(v.dtype != torch.float32 or not torch.isfinite(v).all() for v in state.values()):
            raise RuntimeError(f"TalkNet 2 {tag}: parameters or BatchNorm buffers not finite f32")
        return resumed, wall, tuple(fn.launches for fn in counted)

    filelist = WORK / "fp_train.txt"
    lines = filelist.read_text().splitlines()
    resumed, wall, (b1, b2, mas) = run_cli(
        "asr", ["--model", "asr", "-o", str(WORK / "tn_asr"), "-d", str(filelist), "-bs", "16",
                "--steps-per-epoch", "1"], None)
    if (b1, b2, mas) != (3 * len(lines), 0, 0):
        raise RuntimeError(f"the ASR path launched B1, B2, MAS {(b1, b2, mas)} times in 3 epochs "
                           f"of {len(lines)} utterances; expected {3 * len(lines)}, 0, 0")
    n_params = sum(p.numel() for p in resumed["trainer"].model.parameters())
    log(f"TalkNet 2 ASR training path: QuartzNet 5x5 ({n_params / 1e6:.2f}M parameters), batch 16, "
        f"3 steps (2, then --resume 1) in {wall:.1f} s with set-up and checkpoints; B1 launches "
        f"{b1} ({b1 // 3} an epoch, one an utterance); last epoch "
        + " ".join(f"{k}={v:.4f}" for k, v in sorted(resumed["metrics"].items())) + f" [{card}]")
    # B1 at the ASR dataset's call sites: against its twin on each
    # utterance's frames, and a card batch against the host's
    d_twin, n_frames = b1_against_twin(torch, device, [l.split("|")[0] for l in lines])
    host = next(ASRDataset(str(filelist), "cpu").batches(16, seed=1234))
    on_card = next(ASRDataset(str(filelist), device).batches(16, seed=1234))
    np.testing.assert_allclose(on_card["mel"].cpu().numpy(), host["mel"].numpy(), atol=1e-3,
                               rtol=1e-4)
    for k in ("mel_lens", "labels", "label_lens"):
        np.testing.assert_array_equal(on_card[k], host[k])
    d_host = (on_card["mel"].cpu() - host["mel"]).abs().max().item()
    log(f"  B1 at the ASR call sites: {len(lines)} utterances ({n_frames} frames), B1 vs its twin "
        f"on the card max|diff| {d_twin:.3e}, the card's batch vs the host's {d_host:.3e} (atol "
        f"1e-3, rtol 1e-4)")

    pre = WORK / "fs2_pre"
    for tag, flags in (("f32", []), ("bf16", ["--amp"])):
        for head in ("duration", "pitch", "spectrogram"):
            resumed, wall, counts = run_cli(
                f"{head} ({tag})", ["--model", head, "-o", str(WORK / f"tn_{head}_{tag}"), "-d",
                                    str(pre), "-bs", "12", "--steps-per-epoch", "1"] + flags,
                torch.bfloat16 if flags else None)
            if any(counts):
                raise RuntimeError(f"the TalkNet 2 {head} step ({tag}) launched B1, B2, MAS "
                                   f"{counts} times; expected none")
            log(f"TalkNet 2 {head} training path ({tag}): full width, batch 12, 3 steps (2, then "
                f"--resume 1) in {wall:.1f} s with set-up and checkpoints; last losses "
                + " ".join(f"{k}={v:.4f}" for k, v in sorted(resumed["metrics"].items()))
                + f" [{card}]")

    # serving: the trained heads, the duration head's output bias set to 6
    # frames (3 steps leave its durations near 0: zero-length outputs)
    step3 = WORK / "tn_duration_f32" / "checkpoints" / "3"
    model, config = load_checkpoint(step3, "TalkNet2", device, model_cls=GraphemeDuration)
    with torch.no_grad():
        model.backbone.out.bias.fill_(6.0)
    fe = json.loads((step3 / "model_config.json").read_text())["frontend"]
    served = save_checkpoint(WORK / "tn_serve_duration", "TalkNet2", config, model.state_dict(),
                             fe)
    for tag, flags in (("f32", []), ("bf16", ["--amp"])):
        out = WORK / f"tn_wavs_{tag}"
        t0 = time.perf_counter()
        talknet_infer.main(["--duration-checkpoint", str(served), "--pitch-checkpoint",
                            str(WORK / "tn_pitch_f32"), "--spectrogram-checkpoint",
                            str(WORK / "tn_spectrogram_f32" / "checkpoints"),
                            "--hifigan-checkpoint", str(WORK / "gt_serve" / "hifigan"), "-i",
                            str(WORK / "gt_sentences.txt"), "-o", str(out), "-bs", "8"] + flags)
        torch.cuda.synchronize()
        frames = sum(check_served(f"talknet_infer ({tag})", out))
        log(f"TalkNet 2 serving path ({tag}): {len(SENTENCES)} sentences through the three "
            f"heads and HiFi-GAN v1, batch 8, {frames} frames in {time.perf_counter() - t0:.2f} s "
            f"(first call, checkpoint loads included); mels and wavs of n · hop samples, finite "
            f"[{card}]")
    return b1


def check_buffers(label, steps):
    """The BatchNorm buffers after a step, card vs CPU, at rtol 1e-4 / atol
    1e-5, for each mode in ``steps``; logs the largest difference."""
    worst = {}
    for amp in sorted({a for a, _ in steps}):
        card, cpu = steps[(amp, "cuda")][1], steps[(amp, "cpu")][1]
        keys = [k for k in cpu if "running_" in k]
        if not keys:
            raise RuntimeError(f"{label}: no BatchNorm buffers in the state dict")
        for k in keys:
            np.testing.assert_allclose(card[k].numpy(), cpu[k].numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=f"{label} {'bf16' if amp else 'f32'} {k}")
        worst["bf16" if amp else "f32"] = max((card[k] - cpu[k]).abs().max().item() for k in keys)
    log(f"reference: {label}: {len(keys)} BatchNorm buffers card vs CPU max|diff| "
        + ", ".join(f"{m} {d:.2e}" for m, d in worst.items()) + " (rtol 1e-4, atol 1e-5)")


def phase_talknet_reference(torch, device):
    """One train step of a small QuartzNet ASR and of each small TalkNet 2
    head (widths 64/128 at the real kernels 33, 39 and 87, dropout off),
    batch 3: card vs CPU from the same weights at the trainer tolerances,
    the BatchNorm buffers by :func:`check_buffers`, and the heads' ``--amp``
    steps (bf16 from the head's config) by :func:`check_bf16_step`."""
    from neuraltexttospeech_torch.cli.talknet_train import HEADS, LOSSES
    from neuraltexttospeech_torch.models.talknet import QuartzNet, QuartzNetConfig, TalkNet2Config

    bb = QuartzNetConfig(module_repeat=2, block_params=((64, 33), (64, 39)), initial_filters=64,
                         penultimate_filters=64, final_filters=128)
    rng = np.random.default_rng(41)
    mel_lens = np.asarray([128, 101, 77], np.int32)
    labels = rng.integers(1, 29, (3, 32)).astype(np.int32)
    label_lens = np.asarray([30, 20, 12], np.int32)
    labels[np.arange(32)[None] >= label_lens[:, None]] = 0
    asr_batch = {"mel": (rng.standard_normal((3, 128, 80))
                         * (np.arange(128)[None, :, None] < mel_lens[:, None, None])
                         ).astype(np.float32),
                 "mel_lens": mel_lens, "labels": labels, "label_lens": label_lens}

    def make_asr(amp=False):
        m = QuartzNet(bb)
        m.p_dropout = 0.0
        return m

    models = {"asr": (make_asr, asr_batch, (False,))}
    for kind, cls in HEADS.items():
        def make(amp=False, cls=cls):
            m = cls(TalkNet2Config(emb_dim=64, backbone=bb,
                                   dtype=torch.bfloat16 if amp else None))
            m.backbone.p_dropout = 0.0
            return m

        models[kind] = (make, fastspeech2_batch(rng, 3, 16, 64, 148, [16, 11, 7], 3),
                        (False, True))
    for kind, (make, batch, amps) in models.items():
        torch.manual_seed(42)
        weights = {k: v.clone() for k, v in make().state_dict().items()}
        steps = train_steps_card_and_cpu(torch, make, weights, LOSSES[kind], TN_ADAM, batch,
                                         device, amps=amps, model_amp=True)
        label = f"small TalkNet 2 {kind} train step"
        check_f32_step(label, steps)
        check_buffers(label, steps)
        if True in amps:
            check_bf16_step(label, *({k: v[i] for k, v in steps.items()} for i in range(3)),
                            TN_ADAM["learning_rate"])


def phase_talknet_timing(torch, device, card):
    """TalkNet 2 at full width (``TalkNet2Config()``: QuartzNet 5×5, widths
    256/512, final 1024, emb 256, 80 mels), dropout on, the CLI's Adam: the
    spectrogram head's step at bench.py's FastSpeech 2 shape (16 × 128
    tokens × 768 frames, 6 frames a token), f32 (TF32 off) and ``--amp``;
    the duration head at 16 × 128 and the pitch head at 16 × 128 × 768
    (f32); the ASR step at 16 × 768 frames with 160 labels; then serving
    text → wav through the three heads (the duration head's output at 6
    frames a token) and HiFi-GAN v1 at 8 × 128 tokens, ``max_mel_len`` 1024,
    as an RTF, f32 and ``--amp``."""
    from neuraltexttospeech_torch.cli.hifigan_infer import vocode
    from neuraltexttospeech_torch.cli.talknet_infer import synth
    from neuraltexttospeech_torch.cli.talknet_train import HEADS, LOSSES, optimizer_config
    from neuraltexttospeech_torch.models.hifigan import Generator, HiFiGANConfig
    from neuraltexttospeech_torch.models.talknet import QuartzNet, TalkNet2Config
    from neuraltexttospeech_torch.train.harness import Trainer, TrainerConfig

    B, T_TEXT, T_MEL = 16, 128, 768
    batch = {k: torch.as_tensor(v, device=device) for k, v in fastspeech2_batch(
        np.random.default_rng(34), B, T_TEXT, T_MEL, 148, [T_TEXT] * B, T_MEL // T_TEXT).items()}
    out = {}
    for kind, amp in (("spectrogram", False), ("spectrogram", True), ("duration", False),
                      ("pitch", False)):
        torch.manual_seed(0)
        model = HEADS[kind](TalkNet2Config(dtype=torch.bfloat16 if amp else None))
        trainer = Trainer(LOSSES[kind], model, TrainerConfig(optimizer=optimizer_config(1e-3)),
                          device)
        mode = "bf16 (--amp)" if amp else "f32 (TF32 off)"
        shape = f"{B} x {T_TEXT} tokens" + ("" if kind == "duration" else f" x {T_MEL} frames")
        per_token = kind == "duration"  # the duration head sees no mel frames
        out[kind, amp] = step_timing(
            torch, trainer, batch, f"TalkNet 2 {kind} train step {mode}, full width, dropout "
            f"on: batch {shape}", card, B * (T_TEXT if per_token else T_MEL),
            unit="tokens" if per_token else "mel frames")
        del trainer, model
    rng = np.random.default_rng(35)
    asr = {"mel": torch.as_tensor(rng.standard_normal((B, T_MEL, 80)).astype(np.float32),
                                  device=device),
           "mel_lens": torch.full((B,), T_MEL, dtype=torch.int32, device=device),
           "labels": torch.as_tensor(rng.integers(1, 29, (B, 160)), dtype=torch.int32,
                                     device=device),
           "label_lens": torch.full((B,), 160, dtype=torch.int32, device=device)}
    torch.manual_seed(0)
    trainer = Trainer(LOSSES["asr"], QuartzNet(), TrainerConfig(optimizer=optimizer_config(1e-3)),
                      device)
    out["asr", False] = step_timing(
        torch, trainer, asr, f"TalkNet 2 QuartzNet 5x5 ASR train step f32 (TF32 off), dropout "
        f"on: batch {B} x {T_MEL} frames, 160 labels", card, B * T_MEL)
    del trainer

    weights = {}
    for i, (kind, cls) in enumerate(HEADS.items()):
        weights[kind] = random_init_(cls(TalkNet2Config()).to(device), 50 + i, device).state_dict()
    with torch.no_grad():  # every duration exactly 6 frames: 768 frames an utterance
        weights["duration"]["backbone.out.weight"].zero_()
        weights["duration"]["backbone.out.bias"].fill_(6.0)
    gen = random_init_(Generator(HiFiGANConfig.v1()).to(device).eval(), 4, device)
    text = torch.as_tensor(rng.integers(1, 148, (8, T_TEXT)), dtype=torch.int32, device=device)
    lens = torch.full((8,), T_TEXT, dtype=torch.int32, device=device)
    for amp in (False, True):
        dtype = torch.bfloat16 if amp else None
        heads = []
        for kind, cls in HEADS.items():
            m = cls(TalkNet2Config(dtype=dtype)).to(device)
            m.load_state_dict(weights[kind])
            heads.append(m.eval())

        def run():
            mel, n, _ = synth(heads, text, lens, 1024)
            return n, vocode(gen, mel[:, :-(-int(n.max()) // 128) * 128], dtype)

        wall, walls, _, (n, audio) = timed_calls(torch, run, 3)
        frames = int(n.sum())
        if frames != 8 * T_TEXT * 6 or not torch.isfinite(audio).all():
            raise RuntimeError(f"TalkNet 2 → wav bench: {frames} frames, finite "
                               f"{bool(torch.isfinite(audio).all())}")
        audio_s = frames * HOP / SR
        mode = "bf16 (--amp)" if amp else "f32 (TF32 off)"
        log(f"talknet2wav {mode}: full-width heads + HiFi-GAN v1, batch 8 x {T_TEXT} tokens, "
            f"max_mel_len 1024, {frames} frames = {audio_s:.3f} s audio: wall {wall:.4f} s (runs "
            f"{runs(walls)} ms) = RTF {wall / audio_s:.3e}; peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
        log(f"  trace ({mode}): " + trace_summary(torch, run, wall))
        log(f"  host ({mode}): " + host_summary())
        out["serve", amp] = wall
    return out


def host_summary(top=5):
    """From the last :func:`device_breakdown`: the host's kernel launches,
    copy kernels, casts and ``cudaFuncGetAttributes`` calls, and its CUDA
    runtime calls that took most time."""
    launches, copies, casts, attrs = launch_counts()
    runtime = sorted(device_breakdown.runtime.items(), key=lambda kv: -kv[1][1])[:top]
    return (f"{launches} kernel launches, {copies} copy kernels, {casts} casts, {attrs} "
            f"cudaFuncGetAttributes; runtime calls "
            + "; ".join(f"{name} x{count} {ms:.1f} ms" for name, (count, ms) in runtime))


T2_SMALL = dict(symbols_embedding_dim=64, encoder_embedding_dim=64, decoder_rnn_dim=128,
                attention_rnn_dim=128, attention_dim=32, attention_location_n_filters=8,
                prenet_dim=32, postnet_embedding_dim=64, max_decoder_steps=64)
# AdamW of the Tacotron 2 CLI at eps 1e-5 for the card-vs-CPU step: the
# convs' biases before the BatchNorms have gradients that are zero but for
# rounding, which Adam at eps 1e-8 turns into steps of up to lr either way
T2_ADAMW = dict(optimizer="adamw", learning_rate=1e-3, beta1=0.9, beta2=0.999, eps=1e-5,
                weight_decay=1e-6, grad_clip_norm=1.0)


def tacotron2_batch(rng, batch, t_text, t_mel, n_symbols, text_lens, mel_lens):
    """Random tokens and N(0, 1) mels, zero past each length (numpy)."""
    text = rng.integers(1, n_symbols, (batch, t_text)).astype(np.int32)
    text[np.arange(t_text)[None] >= np.asarray(text_lens)[:, None]] = 0
    mel = rng.standard_normal((batch, t_mel, 80)).astype(np.float32)
    mel[np.arange(t_mel)[None] >= np.asarray(mel_lens)[:, None]] = 0.0
    return {"text": text, "input_lens": np.asarray(text_lens, np.int32), "mel": mel,
            "mel_lens": np.asarray(mel_lens, np.int32)}


def phase_tacotron2_cli(torch, device, card):
    """Tacotron 2 through its CLIs at full width: the FastPitch phase's 16
    synthetic wavs through ``tacotron2_prepare_dataset`` on the card (B1 once
    a wav, counted; each cached log-mel held against the host's plain path,
    and B1 against its twin on each wav's frames); ``tacotron2_train`` at
    ``Tacotron2Config()``, batch 16, 2 steps then ``--resume`` for a 3rd, f32
    and ``--amp`` (no kernel launched: the mels are cached); then
    ``tacotron2_infer`` of the 16 sentences with the serving phase's HiFi-GAN
    v1, f32 and ``--amp``, 1000 decoder steps: finite wavs of ``n · 256``
    samples. Returns B1's launches in prep."""
    from neuraltexttospeech_torch.audio.stft import STFT
    from neuraltexttospeech_torch.cli import (tacotron2_infer, tacotron2_prepare_dataset,
                                              tacotron2_train)
    from neuraltexttospeech_torch.data.filelist import load_wav
    from neuraltexttospeech_torch.ops import mel_kernel

    counted = counted_kernels()
    filelist, feats = WORK / "fp_train.txt", WORK / "t2_feats"
    wavs = [line.split("|")[0] for line in filelist.read_text().splitlines()]
    mel_kernel.fused_frames_to_mel.launches = 0
    t0 = time.perf_counter()
    tacotron2_prepare_dataset.main(["-d", str(feats), "--training-files", str(filelist)])
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    b1_prep = mel_kernel.fused_frames_to_mel.launches
    if b1_prep != len(wavs):
        raise RuntimeError(f"Tacotron 2 prep launched B1 {b1_prep} times for {len(wavs)} wavs")
    host, d_host = STFT(device="cpu"), 0.0
    for path in wavs:
        saved = np.load(feats / pathlib.Path(path).name.replace(".wav", "_mel.npy"))
        want = host.mel_spectrogram(load_wav(path, SR)[0]).numpy()
        np.testing.assert_allclose(saved, want, atol=1e-3, rtol=1e-4, err_msg=path)
        d_host = max(d_host, float(np.abs(saved - want).max()))
    d_twin, n_frames = b1_against_twin(torch, device, wavs)
    log(f"Tacotron 2 prep path: {len(wavs)} wavs ({n_frames} frames) in {prep_s:.2f} s; B1 "
        f"launches {b1_prep}; cached log-mels vs the host's plain path max|diff| {d_host:.3e}, "
        f"B1 vs its twin on the card {d_twin:.3e} (atol 1e-3, rtol 1e-4) [{card}]")

    for tag, flags in (("f32", []), ("bf16", ["--amp"])):
        argv = ["-o", str(WORK / f"t2_train_{tag}"), "-d", str(feats), "--training-files",
                str(filelist), "-bs", "16", "--steps-per-epoch", "1"] + flags
        for fn in counted:
            fn.launches = 0
        t0 = time.perf_counter()
        first = tacotron2_train.main(argv + ["--epochs", "2"])
        resumed = tacotron2_train.main(argv + ["--epochs", "3", "--resume"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        trainer, dtype = resumed["trainer"], torch.bfloat16 if flags else None
        counts = tuple(fn.launches for fn in counted)
        if (first["steps"], resumed["steps"], trainer.step, resumed["config"].dtype) != (
                2, 1, 3, dtype) or any(counts):
            raise RuntimeError(f"Tacotron 2 trainer ({tag}): {first['steps']} + "
                               f"{resumed['steps']} steps, step {trainer.step}, B1/B2/MAS "
                               f"launches {counts}")
        for run in (first, resumed):
            if not run["metrics"] or not all(np.isfinite(v) for v in run["metrics"].values()):
                raise RuntimeError(f"non-finite or missing Tacotron 2 metrics ({tag}): {run}")
        state = trainer.model.state_dict()
        if any(v.dtype != torch.float32 or not torch.isfinite(v).all() for v in state.values()):
            raise RuntimeError(f"Tacotron 2 ({tag}): parameters or buffers not finite f32")
        n_params = sum(p.numel() for p in trainer.model.parameters())
        log(f"Tacotron 2 training path ({tag}): Tacotron2Config() ({n_params / 1e6:.2f}M "
            f"parameters), batch 16, 3 steps (2, then --resume 1) in {wall:.1f} s with set-up "
            f"and checkpoints; B1/B2/MAS launches {counts}; last losses "
            + " ".join(f"{k}={v:.4f}" for k, v in sorted(resumed["metrics"].items()))
            + f" [{card}]")
        del trainer, first, resumed

    for tag, flags in (("f32", []), ("bf16", ["--amp"])):
        out = WORK / f"t2_wavs_{tag}"
        t0 = time.perf_counter()
        tacotron2_infer.main(["--checkpoint", str(WORK / "t2_train_f32"), "--hifigan-checkpoint",
                              str(WORK / "gt_serve" / "hifigan"), "-i",
                              str(WORK / "gt_sentences.txt"), "-o", str(out), "-bs", "8"]
                             + flags)
        torch.cuda.synchronize()
        frames = check_served(f"tacotron2_infer ({tag})", out, 1000)
        log(f"Tacotron 2 serving path ({tag}): {len(SENTENCES)} sentences, batch 8, 1000 decoder "
            f"steps, HiFi-GAN v1: {sum(frames)} frames ({min(frames)}–{max(frames)} an "
            f"utterance) in {time.perf_counter() - t0:.2f} s (first call, checkpoint loads "
            f"included); mels and wavs of n · hop samples, finite [{card}]")
    return b1_prep


def phase_tacotron2_reference(torch, device):
    """A small Tacotron 2 (``T2_SMALL``: widths 32–128, the real kernels 5
    and 31, 64 decoder steps), card vs CPU from the same weights, dropout
    off (the two devices' generators draw differently): the eval and
    train-mode forwards (the card's encoder BiLSTM through cuDNN, the CPU's
    through the loop) at atol 1e-4 / rtol 1e-4; one train step (AdamW at eps
    1e-5) at the trainer tolerances, its BatchNorm buffers by
    :func:`check_buffers`, and its ``--amp`` step by :func:`check_bf16_step`
    (the bf16 step's buffers by :func:`bf16_yardstick`);
    ``infer`` in both forms where every row runs to the cap and where every
    row stops at its first frame: ``mel_lengths`` equal, mels at atol 1e-4."""
    from neuraltexttospeech_torch.models.tacotron2 import Tacotron2, Tacotron2Config
    from neuraltexttospeech_torch.models.tacotron2_train import loss_fn

    def make(amp=False):
        return Tacotron2(Tacotron2Config(**T2_SMALL, dtype=torch.bfloat16 if amp else None))

    torch.manual_seed(61)
    weights = {k: v.clone() for k, v in make().state_dict().items()}
    batch = tacotron2_batch(np.random.default_rng(62), 3, 24, 48, 148, [24, 17, 9],
                            [48, 40, 23])
    cpu = torch.device("cpu")
    outs = {}
    for dev in (device, cpu):
        m = make().to(dev)
        m.load_state_dict(weights)
        t = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        with torch.no_grad():
            for train in (False, True):
                out = m.train(train)(t["text"], t["input_lens"], t["mel"], t["mel_lens"])
                outs[dev.type, train] = [x.cpu() for x in out[:4]]
    worst = 0.0
    for train in (False, True):
        for got, want in zip(outs["cuda", train], outs["cpu", train]):
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
            worst = max(worst, (got - want).abs().max().item())
    log(f"reference: small Tacotron 2 eval and train forwards card vs CPU max|diff| {worst:.2e} "
        f"(atol 1e-4, rtol 1e-4)")
    steps = train_steps_card_and_cpu(
        torch, make, weights, lambda model, b, generator: loss_fn(model, b, None), T2_ADAMW,
        batch, device, model_amp=True)
    label = "small Tacotron 2 train step"
    check_f32_step(label, steps)
    check_buffers(label, {k: v for k, v in steps.items() if not k[0]})
    check_bf16_step(label, *({k: v[i] for k, v in steps.items()} for i in range(3)),
                    T2_ADAMW["learning_rate"])
    # bf16: the statistics of bf16 conv outputs, which the card's cuDNN and
    # the CPU round differently, by the yardstick against the CPU's f32 step
    buffers = [k for k in weights if "running_" in k]
    worst = max(bf16_yardstick(f"{label} {k}", *(steps[m][1][k].numpy() for m in (
        (True, "cuda"), (True, "cpu"), (False, "cpu"))))[0] for k in buffers)
    log(f"reference: {label}: {len(buffers)} bf16 BatchNorm buffers card vs CPU max|diff| "
        f"{worst:.2e}, each within the bf16 yardstick")

    for case, bias in (("cap", -50.0), ("first frame", 50.0)):
        res = {}
        for dev in (device, cpu):
            m = make().to(dev)
            m.load_state_dict(weights)
            with torch.no_grad():
                m.cell.gate_layer.bias.fill_(bias)
                t = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
                for early in (False, True):
                    out = m.infer(t["text"], t["input_lens"], early_stop=early)
                    res[dev.type, early] = [x.cpu() for x in out]
        for early in (False, True):
            card, host = res["cuda", early], res["cpu", early]
            if not torch.equal(card[4], host[4]):
                raise RuntimeError(f"Tacotron 2 infer ({case}, early_stop={early}): mel_lengths "
                                   f"{card[4].tolist()} on the card, {host[4].tolist()} on the CPU")
            want_len = 64 if case == "cap" else 1
            if not (host[4] == want_len).all():
                raise RuntimeError(f"Tacotron 2 infer ({case}): mel_lengths {host[4].tolist()}")
            for got, want in zip(card[:4], host[:4]):
                torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        d = max((a - b).abs().max().item() for e in (False, True)
                for a, b in zip(res["cuda", e][:4], res["cpu", e][:4]))
        log(f"reference: small Tacotron 2 infer ({case}), scan and while forms: mel_lengths "
            f"{res['cpu', False][4].tolist()} on both devices, outputs max|diff| {d:.2e}")


def phase_tacotron2_timing(torch, device, card):
    """Tacotron 2 at full width (``Tacotron2Config()``, 28M parameters): the
    train step at bench.py:584-593's shape, 64 × 128 random tokens × 512
    N(0, 1) frames, full lengths, dropout on, the CLI's AdamW with clip, f32
    (TF32 off) and ``--amp``; then serving: 8 × 128 random tokens through
    ``infer`` (1000 decoder steps: the gate bias at -50, so no row stops),
    then HiFi-GAN v1 on the 8 × 1000 frames (92.88 s of audio), as an RTF, f32
    and bf16, each with a profiler split."""
    from neuraltexttospeech_torch.cli.hifigan_infer import vocode
    from neuraltexttospeech_torch.models.hifigan import Generator, HiFiGANConfig
    from neuraltexttospeech_torch.models.tacotron2 import Tacotron2, Tacotron2Config
    from neuraltexttospeech_torch.models.tacotron2_train import loss_fn, optimizer_config
    from neuraltexttospeech_torch.train.harness import Trainer, TrainerConfig

    B, T_TEXT, T_MEL = 64, 128, 512
    batch = {k: torch.as_tensor(v, device=device) for k, v in tacotron2_batch(
        np.random.default_rng(71), B, T_TEXT, T_MEL, 148, [T_TEXT] * B, [T_MEL] * B).items()}
    out = {}
    for amp in (False, True):
        torch.manual_seed(0)
        trainer = Trainer(loss_fn, Tacotron2(Tacotron2Config(dtype=torch.bfloat16 if amp
                                                             else None)),
                          TrainerConfig(optimizer=optimizer_config()), device)
        mode = "bf16 (--amp)" if amp else "f32 (TF32 off)"
        out["step", amp] = step_timing(
            torch, trainer, batch, f"Tacotron 2 train step {mode}, full width, dropout on: batch "
            f"{B} x {T_TEXT} tokens x {T_MEL} frames", card, B * T_MEL)
        log(f"  host ({mode}): " + host_summary())
        del trainer

    torch.manual_seed(1)
    weights = random_init_(Tacotron2(Tacotron2Config()).to(device), 72, device).state_dict()
    with torch.no_grad():
        weights["cell.gate_layer.bias"].fill_(-50.0)
    gen = random_init_(Generator(HiFiGANConfig.v1()).to(device).eval(), 4, device)
    rng = np.random.default_rng(73)
    text = torch.as_tensor(rng.integers(1, 148, (8, T_TEXT)), dtype=torch.int32, device=device)
    lens = torch.full((8,), T_TEXT, dtype=torch.int32, device=device)
    for amp in (False, True):
        dtype = torch.bfloat16 if amp else None
        model = Tacotron2(Tacotron2Config(dtype=dtype)).to(device).eval()
        model.load_state_dict(weights)

        def run():
            g = torch.Generator(device=device)
            g.manual_seed(7)
            with torch.inference_mode():
                o = model.infer(text, lens, generator=g)
            n = o.mel_lengths
            return n, vocode(gen, o.mel_out_postnet.float()[:, :min(-(-int(n.max()) // 128) * 128,
                                                                     1000)], dtype)

        wall, walls, _, (n, audio) = timed_calls(torch, run, 3)
        frames = int(n.sum())
        if frames != 8 * 1000 or not torch.isfinite(audio).all():
            raise RuntimeError(f"Tacotron 2 → wav bench: {frames} frames, finite "
                               f"{bool(torch.isfinite(audio).all())}")
        audio_s = frames * HOP / SR
        mode = "bf16 (--amp)" if amp else "f32 (TF32 off)"
        log(f"tacotron2wav {mode}: full-width Tacotron 2 (1000 decoder steps) + HiFi-GAN v1, "
            f"batch 8 x {T_TEXT} tokens, {frames} frames = {audio_s:.3f} s audio: wall "
            f"{wall:.4f} s (runs {runs(walls)} ms) = RTF {wall / audio_s:.3e}; peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
        log(f"  trace ({mode}): " + trace_summary(torch, run, wall))
        log(f"  host ({mode}): " + host_summary())
        out["serve", amp] = wall
    return out


def phase_flowtron_cli(torch, device, card):
    """Flowtron through its CLIs at full width (``FlowtronConfig()``): the
    FastPitch phase's 16 synthetic wavs through ``tacotron2_prepare_dataset``
    on the card (Flowtron's features: B1 once a wav, counted; each cached
    log-mel held against the host's plain path); ``flowtron_train``, batch
    16, a validation pass each epoch, 2 steps then ``--resume`` for a 3rd,
    f32 and ``--amp`` (no kernel launched: the mels are cached); then
    ``flowtron_infer`` of the 16 sentences with the serving phase's HiFi-GAN
    v1, 400 frames, f32 and ``--amp``: finite mels and wavs of ``n · 256``
    samples. Returns B1's launches in prep."""
    from neuraltexttospeech_torch.audio.stft import STFT
    from neuraltexttospeech_torch.cli import (flowtron_infer, flowtron_train,
                                              tacotron2_prepare_dataset)
    from neuraltexttospeech_torch.data.filelist import load_wav
    from neuraltexttospeech_torch.ops import mel_kernel

    filelist, feats = WORK / "fp_train.txt", WORK / "fl_feats"
    wavs = [line.split("|")[0] for line in filelist.read_text().splitlines()]
    counted = counted_kernels()
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    tacotron2_prepare_dataset.main(["-d", str(feats), "--training-files", str(filelist)])
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    b1_prep = mel_kernel.fused_frames_to_mel.launches
    if b1_prep != len(wavs) or any(fn.launches for fn in counted[1:]):
        raise RuntimeError(f"Flowtron prep launched B1/B2/MAS "
                           f"{tuple(fn.launches for fn in counted)} times for {len(wavs)} wavs")
    host, d_host = STFT(device="cpu"), 0.0
    for path in wavs:
        saved = np.load(feats / pathlib.Path(path).name.replace(".wav", "_mel.npy"))
        want = host.mel_spectrogram(load_wav(path, SR)[0]).numpy()
        np.testing.assert_allclose(saved, want, atol=1e-3, rtol=1e-4, err_msg=path)
        d_host = max(d_host, float(np.abs(saved - want).max()))
    log(f"Flowtron prep path: {len(wavs)} wavs in {prep_s:.2f} s; B1 launches {b1_prep}; cached "
        f"log-mels vs the host's plain path max|diff| {d_host:.3e} (atol 1e-3, rtol 1e-4) "
        f"[{card}]")

    for tag, flags in (("f32", []), ("bf16", ["--amp"])):
        argv = ["-o", str(WORK / f"fl_train_{tag}"), "-d", str(feats), "--training-files",
                str(filelist), "--validation-files", str(filelist), "-bs", "16",
                "--steps-per-epoch", "1"] + flags
        for fn in counted:
            fn.launches = 0
        t0 = time.perf_counter()
        first = flowtron_train.main(argv + ["--epochs", "2"])
        resumed = flowtron_train.main(argv + ["--epochs", "3", "--resume"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        trainer, dtype = resumed["trainer"], torch.bfloat16 if flags else None
        counts = tuple(fn.launches for fn in counted)
        if (first["steps"], resumed["steps"], trainer.step, resumed["config"].dtype) != (
                2, 1, 3, dtype) or any(counts):
            raise RuntimeError(f"Flowtron trainer ({tag}): {first['steps']} + "
                               f"{resumed['steps']} steps, step {trainer.step}, B1/B2/MAS "
                               f"launches {counts}")
        for run in (first, resumed):
            metrics = {**run["metrics"], **run["val"]}
            if not run["metrics"] or not run["val"] or not all(
                    np.isfinite(v) for v in metrics.values()):
                raise RuntimeError(f"non-finite or missing Flowtron metrics ({tag}): {run}")
        state = trainer.model.state_dict()
        if any(v.dtype != torch.float32 or not torch.isfinite(v).all() for v in state.values()):
            raise RuntimeError(f"Flowtron ({tag}): parameters not finite f32")
        n_params = sum(p.numel() for p in trainer.model.parameters())
        log(f"Flowtron training path ({tag}): FlowtronConfig() ({n_params / 1e6:.2f}M "
            f"parameters), batch 16, 3 steps (2, then --resume 1) and a validation pass an epoch "
            f"in {wall:.1f} s with set-up and checkpoints; B1/B2/MAS launches {counts}; last "
            f"losses " + " ".join(f"{k}={v:.4f}" for k, v in sorted(resumed["metrics"].items()))
            + "; validation " + " ".join(f"{k}={v:.4f}" for k, v in sorted(resumed["val"].items()))
            + f" [{card}]")
        del trainer, first, resumed

    for tag, flags in (("f32", []), ("bf16", ["--amp"])):
        out = WORK / f"fl_wavs_{tag}"
        t0 = time.perf_counter()
        flowtron_infer.main(["--checkpoint", str(WORK / "fl_train_f32"), "--hifigan-checkpoint",
                             str(WORK / "gt_serve" / "hifigan"), "-i",
                             str(WORK / "gt_sentences.txt"), "-o", str(out), "-bs", "8",
                             "--n-frames", "400"] + flags)
        torch.cuda.synchronize()
        frames = check_served(f"flowtron_infer ({tag})", out, 400)
        log(f"Flowtron serving path ({tag}): {len(SENTENCES)} sentences, batch 8, 400 frames of "
            f"z (sigma 0.8), HiFi-GAN v1: {sum(frames)} frames ({min(frames)}–{max(frames)} an "
            f"utterance after the gate trim) in {time.perf_counter() - t0:.2f} s (first call, "
            f"checkpoint loads included); mels and wavs of n · hop samples, finite [{card}]")
    return b1_prep


def phase_tools_cli(torch, device, card):
    """The data tools on the card, on the earlier phases' checkpoints:
    ``dump_mels --model fastpitch`` (the FastPitch phase's f32 run, its
    prepared features; MAS once a batch of 8, counted) and ``--model
    tacotron2`` (the Tacotron 2 phase's f32 run; no kernel), each mel the
    length of its cached log-mel and finite; one v1 GAN step through
    ``hifigan_train --fine-tuning-mel-dir`` on the FastPitch mels (B1 once,
    B2 as in any GAN step); ``align_from_fastpitch`` (MAS once a batch,
    counted; durations summing to each mel's frames), then one
    ``fastspeech2_train`` step (batch 16) on its output; ``export`` of the
    FastPitch run, reloaded on the card and held equal to the checkpoint's
    model. Returns MAS's launches on the two tools' paths."""
    from neuraltexttospeech_torch.cli import (align_from_fastpitch, dump_mels, export,
                                              fastspeech2_train, hifigan_train)
    from neuraltexttospeech_torch.models.registry import load_checkpoint
    from neuraltexttospeech_torch.train.checkpoint import checkpoint_dir

    counted = counted_kernels()
    filelist = WORK / "fp_train.txt"
    stems = [pathlib.Path(line.split("|")[0]).stem for line in filelist.read_text().splitlines()]
    batches = -(-len(stems) // 8)
    mas = {}
    for model, run, feats in (("fastpitch", "fp_train_f32", "fp_feats"),
                              ("tacotron2", "t2_train_f32", "t2_feats")):
        out = WORK / f"dumped_{model}"
        for fn in counted:
            fn.launches = 0
        t0 = time.perf_counter()
        dump_mels.main(["--model", model, "--checkpoint", str(WORK / run), "-d",
                        str(WORK / feats), "--training-files", str(filelist), "-o", str(out),
                        "--batch-size", "8"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = tuple(fn.launches for fn in counted)
        want_mas = batches if model == "fastpitch" else 0
        if counts != (0, 0, want_mas):
            raise RuntimeError(f"dump_mels --model {model} launched B1/B2/MAS {counts} times; "
                               f"expected (0, 0, {want_mas})")
        for stem in stems:
            mel, ref = (np.load(d / f"{stem}_mel.npy") for d in (out, WORK / feats))
            if mel.shape != ref.shape or not np.isfinite(mel).all():
                raise RuntimeError(f"dump_mels --model {model} {stem}: {mel.shape}, cached "
                                   f"{ref.shape}")
        mas[f"dump_mels {model}"] = counts[2]
        log(f"dump_mels --model {model}: {len(stems)} utterances in {batches} batches of 8 in "
            f"{wall:.2f} s; B1/B2/MAS launches {counts} [{card}]")

    for fn in counted:
        fn.launches = 0
    run = hifigan_train.main(["--config", "v1", "-o", str(WORK / "train_ft_dumped"),
                              "--training-files", str(filelist), "--steps-per-epoch", "1",
                              "--epochs", "1", "--fine-tuning-mel-dir",
                              str(WORK / "dumped_fastpitch")])
    torch.cuda.synchronize()
    b1, b2 = counted[0].launches, counted[1].launches
    if (run["steps"] != 1 or not all(np.isfinite(v) for v in run["metrics"].values())
            or b1 != 1 or b2 != b2_launches_per_step(8192)):
        raise RuntimeError(f"fine-tuning on dumped mels: {run['steps']} steps, B1 {b1}, B2 {b2}, "
                           f"{run['metrics']}")
    log(f"fine-tuning on FastPitch's dumped mels: one v1 GAN step, batch 16 x 8192; B1 {b1}, "
        f"B2 {b2}; losses " + " ".join(f"{k}={v:.4f}" for k, v in sorted(run["metrics"].items())))

    aligned = WORK / "fp_aligned"
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    lines = align_from_fastpitch.main(["--checkpoint", str(WORK / "fp_train_f32"), "-d",
                                       str(WORK / "fp_feats"), "--training-files", str(filelist),
                                       "-o", str(aligned), "--batch-size", "8"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = tuple(fn.launches for fn in counted)
    if counts != (0, 0, batches) or len(lines) != len(stems):
        raise RuntimeError(f"align_from_fastpitch: {len(lines)} lines, B1/B2/MAS {counts}")
    for stem in stems:
        d = np.load(aligned / f"{stem}_duration.npy")
        n_mel = np.load(aligned / f"{stem}_mel.npy").shape[0]
        p, e = (np.load(aligned / f"{stem}_{k}.npy") for k in ("pitch", "energy"))
        if int(d.sum()) != n_mel or p.shape != d.shape or e.shape != d.shape or not (
                np.isfinite(p).all() and np.isfinite(e).all()):
            raise RuntimeError(f"align_from_fastpitch {stem}: durations sum {d.sum()} of "
                               f"{n_mel} frames, pitch {p.shape}, energy {e.shape}")
    mas["align_from_fastpitch"] = counts[2]
    fs2 = fastspeech2_train.main(["-o", str(WORK / "fs2_aligned"), "-d", str(aligned), "-bs",
                                  "16", "--steps-per-epoch", "1", "--epochs", "1"])
    if fs2["steps"] != 1 or not all(np.isfinite(v) for v in fs2["metrics"].values()):
        raise RuntimeError(f"fastspeech2_train on the aligned corpus: {fs2}")
    log(f"align_from_fastpitch: {len(lines)} utterances in {wall:.2f} s, durations summing to "
        f"each mel's frames; B1/B2/MAS launches {counts}; then one fastspeech2_train step on "
        f"them: " + " ".join(f"{k}={v:.4f}" for k, v in sorted(fs2["metrics"].items()))
        + f" [{card}]")

    art = WORK / "export" / "fastpitch.pt"
    meta = export.main(["--model", "FastPitch", "--checkpoint", str(WORK / "fp_train_f32"),
                        "-o", str(art)])
    exported, _ = export.load_export(art, device)
    ref, _ = load_checkpoint(checkpoint_dir(WORK / "fp_train_f32"), "FastPitch", device)
    text = torch.randint(1, 148, (4, 32), device=device,
                         generator=torch.Generator(device=device).manual_seed(1))
    with torch.no_grad():
        for x, y in zip(exported.infer(text, None, max_mel_len=256),
                        ref.infer(text, None, max_mel_len=256)):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)
    log(f"export: FastPitch step {meta['step']} → {art.name} "
        f"({art.stat().st_size / 1e6:.1f} MB), reloaded on the card: infer equal to the "
        f"checkpoint's model")
    return mas


# a small Flowtron for the card-vs-CPU checks: every width cut, the real 80 mels
FL_SMALL = dict(n_text_dim=64, n_speaker_dim=16, n_attn_channels=64, n_hidden=128)
# Adam at eps 1e-5 for the card-vs-CPU step: the encoders' conv biases feed
# instance norms, so their gradients are zero but for rounding
FL_ADAM = dict(learning_rate=1e-3, beta1=0.9, beta2=0.999, eps=1e-5, grad_clip_norm=1.0)


def flowtron_batch(rng, batch, t_text, t_mel, n_text, text_lens, mel_lens):
    """Random tokens and N(0, 1) mels, zero past each length (numpy)."""
    out = tacotron2_batch(rng, batch, t_text, t_mel, n_text, text_lens, mel_lens)
    out["speaker"] = np.zeros(batch, np.int32)
    return out


def phase_flowtron_reference(torch, device):
    """A small Flowtron (``FL_SMALL``), card vs CPU from the same weights,
    dropout off: the density pass with ragged lengths (the card's LSTMs
    through cuDNN, one call a pass, the CPU's through the loop) and
    ``infer`` on the same ``z`` at atol 1e-4 / rtol 1e-4; one train step at
    the trainer tolerances, and its ``--amp`` step by
    :func:`check_bf16_step`."""
    from neuraltexttospeech_torch.cli.flowtron_train import make_loss_fn
    from neuraltexttospeech_torch.models.flowtron import Flowtron, FlowtronConfig

    def make(amp=False):
        return Flowtron(FlowtronConfig(**FL_SMALL, dtype=torch.bfloat16 if amp else None))

    torch.manual_seed(81)
    weights = {k: v.clone() for k, v in
               random_init_(make(), 82, torch.device("cpu")).state_dict().items()}
    batch = flowtron_batch(np.random.default_rng(83), 3, 24, 64, 185, [24, 17, 9],
                           [64, 51, 30])
    z = np.random.default_rng(84).standard_normal((3, 48, 80)).astype(np.float32) * 0.8
    outs = {}
    for dev in (device, torch.device("cpu")):
        m = make().to(dev)
        m.load_state_dict(weights)
        t = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        with torch.no_grad():
            out = m(t["mel"], t["speaker"], t["text"], t["input_lens"], t["mel_lens"])
            mel, gate, attns = m.infer(torch.as_tensor(z, device=dev), t["speaker"], t["text"],
                                       t["input_lens"])
        outs[dev.type] = [x.cpu() for x in (out.z, out.log_s_sum, out.gate_out, *out.attns,
                                            mel, gate, *attns)]
    worst = 0.0
    for got, want in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        worst = max(worst, (got - want).abs().max().item())
    log(f"reference: small Flowtron density pass (cuDNN LSTMs against the CPU's loop) and infer "
        f"card vs CPU max|diff| {worst:.2e} (atol 1e-4, rtol 1e-4)")
    loss_fn = make_loss_fn()
    steps = train_steps_card_and_cpu(torch, make, weights,
                                     lambda model, b, generator: loss_fn(model, b, None),
                                     FL_ADAM, batch, device, model_amp=True)
    label = "small Flowtron train step"
    check_f32_step(label, steps)
    check_bf16_step(label, *({k: v[i] for k, v in steps.items()} for i in range(3)),
                    FL_ADAM["learning_rate"])


def phase_flowtron_timing(torch, device, card):
    """Flowtron at full width (``FlowtronConfig()``): the train step at
    bench.py:614-673's shape, 96 × 128 random tokens × 384 N(0, 1) frames,
    full lengths, dropout on, the CLI's Adam, f32 (TF32 off) and ``--amp``
    (the ``[96, 384, 128, 640]`` attention energies of each flow held for
    the backward); then serving: 8 × 128 random tokens through ``infer`` on
    1000 frames of z (σ 0.8; the gate bias at −50, so no row stops), then
    HiFi-GAN v1 on the 8 × 1000 frames (92.88 s of audio), as an RTF, f32 and
    bf16, each with a profiler split and peak memory."""
    from neuraltexttospeech_torch.cli.flowtron_train import make_loss_fn
    from neuraltexttospeech_torch.cli.hifigan_infer import vocode
    from neuraltexttospeech_torch.models.flowtron import Flowtron, FlowtronConfig
    from neuraltexttospeech_torch.models.hifigan import Generator, HiFiGANConfig
    from neuraltexttospeech_torch.train.harness import Trainer, TrainerConfig
    from neuraltexttospeech_torch.train.state import OptimizerConfig

    B, T_TEXT, T_MEL = 96, 128, 384
    batch = {k: torch.as_tensor(v, device=device) for k, v in flowtron_batch(
        np.random.default_rng(91), B, T_TEXT, T_MEL, 185, [T_TEXT] * B, [T_MEL] * B).items()}
    opt = OptimizerConfig(learning_rate=1e-4, grad_clip_norm=1.0, beta2=0.999, eps=1e-8)
    out = {}
    for amp in (False, True):
        torch.manual_seed(0)
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(make_loss_fn(), Flowtron(FlowtronConfig(dtype=torch.bfloat16 if amp
                                                                  else None)),
                          TrainerConfig(optimizer=opt), device)
        mode = "bf16 (--amp)" if amp else "f32 (TF32 off)"
        out["step", amp] = step_timing(
            torch, trainer, batch, f"Flowtron train step {mode}, full width, dropout on: batch "
            f"{B} x {T_TEXT} tokens x {T_MEL} frames", card, B * T_MEL)
        log(f"  host ({mode}): " + host_summary())
        del trainer
        torch.cuda.empty_cache()

    torch.manual_seed(1)
    weights = random_init_(Flowtron(FlowtronConfig()).to(device), 92, device).state_dict()
    with torch.no_grad():
        weights["flows.1.gate_layer.bias"].fill_(-50.0)
    gen = random_init_(Generator(HiFiGANConfig.v1()).to(device).eval(), 4, device)
    rng = np.random.default_rng(93)
    text = torch.as_tensor(rng.integers(1, 185, (8, T_TEXT)), dtype=torch.int32, device=device)
    lens = torch.full((8,), T_TEXT, dtype=torch.int32, device=device)
    speaker = torch.zeros(8, dtype=torch.int32, device=device)
    z = torch.randn((8, 1000, 80), generator=torch.Generator(device=device).manual_seed(94),
                    device=device) * 0.8
    for amp in (False, True):
        dtype = torch.bfloat16 if amp else None
        model = Flowtron(FlowtronConfig(dtype=dtype)).to(device).eval()
        model.load_state_dict(weights)

        def run():
            with torch.inference_mode():
                mel, gate, _ = model.infer(z, speaker, text, lens)
            return gate, vocode(gen, mel.float(), dtype)

        wall, walls, _, (gate, audio) = timed_calls(torch, run, 3)
        if (torch.sigmoid(gate.float()) > 0.5).any() or not torch.isfinite(audio).all():
            raise RuntimeError(f"Flowtron → wav bench: a gate fired or the audio is not finite")
        frames = 8 * 1000
        audio_s = frames * HOP / SR
        mode = "bf16 (--amp)" if amp else "f32 (TF32 off)"
        log(f"flowtron2wav {mode}: full-width Flowtron (2 flows x 1000 frames) + HiFi-GAN v1, "
            f"batch 8 x {T_TEXT} tokens, {frames} frames = {audio_s:.3f} s audio: wall "
            f"{wall:.4f} s (runs {runs(walls)} ms) = RTF {wall / audio_s:.3e}; peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
        log(f"  trace ({mode}): " + trace_summary(torch, run, wall))
        log(f"  host ({mode}): " + host_summary())
        out["serve", amp] = wall
    return out


def _state_arrays(modules):
    return {f"{i}.{k}": v.detach().float().cpu() for i, m in enumerate(modules)
            for k, v in m.state_dict().items()}


def _held_to_plain(label, m_plain, m_dp, s_plain, s_dp):
    """The data-parallel step's metrics (rtol 2e-5) and parameters and
    buffers (atol 3e-5) against the plain one-card step's; returns the worst
    metric's relative error and the worst parameter's difference."""
    rel = max(abs(m_dp[k] - v) / max(abs(v), 1e-12) for k, v in m_plain.items())
    for k, v in m_plain.items():
        np.testing.assert_allclose(m_dp[k], v, rtol=2e-5, atol=1e-7, err_msg=f"{label}: {k}")
    worst = 0.0
    for k, v in s_plain.items():
        np.testing.assert_allclose(s_dp[k].numpy(), v.numpy(), rtol=0, atol=3e-5,
                                   err_msg=f"{label}: {k}")
        worst = max(worst, (s_dp[k] - v).abs().max().item())
    return rel, worst


def phase_parallel(torch, device, card):
    """Data and tensor parallelism (``parallel/``) on the one card.

    (a) NCCL at world size 1, joined through ``initialize_distributed`` in
    this process: the FastPitch ``Trainer`` step at the ``bench.py`` shape
    (16 × 128 tokens × 768 frames, ragged lengths, dropout on) and the v1
    ``HiFiGANTrainer`` step (16 × 8192), each with a one-rank data-parallel
    mesh, held to the plain one-card step (metrics rtol 2e-5, parameters
    atol 3e-5; both compared steps with cuDNN's deterministic algorithms),
    with MAS ×1 and B1 ×3, B2 ×90 counted in the mesh's step;
    then both steps' walls, plain and on the mesh in 4 turns, and the GAN
    step's idle share in both. (b) Two processes joined by gloo, both ranks on
    ``cuda:0`` (NCCL refuses two ranks on one card):
    ``tools/torch_parallel_check.py`` holds a DP = 2 FastPitch step (ragged,
    dropout on), a DP = 2 TalkNet 2 spectrogram step (BatchNorm), a DP = 2
    GAN step of a small generator with the full MPD and MSD and a TP = 2
    2-head (and 1-head) FastPitch against the one-process step, and counts
    each rank's B1, B2 and MAS launches. (c) The host-fed FastPitch loop,
    ``tools/torch_cli_throughput.py`` at 2 epochs × 8 steps."""
    import socket

    import torch.distributed as dist
    from neuraltexttospeech_torch.cli.fastpitch_train import make_loss_fn
    from neuraltexttospeech_torch.models.fastpitch import FastPitch, FastPitchConfig
    from neuraltexttospeech_torch.models.fastpitch_loss import FastPitchLossConfig
    from neuraltexttospeech_torch.models.hifigan import HiFiGANConfig
    from neuraltexttospeech_torch.models.hifigan_gan import HiFiGANTrainer
    from neuraltexttospeech_torch.parallel import initialize_distributed, make_mesh
    from neuraltexttospeech_torch.parallel.mesh import FlatGrads
    from neuraltexttospeech_torch.train.harness import Trainer, TrainerConfig
    from tools import torch_parallel_check

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b1, b2, mas = counted_kernels()
    t_phase = time.perf_counter()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    if not initialize_distributed(f"127.0.0.1:{port}", 1, 0, device=device):
        raise RuntimeError("initialize_distributed did not join the one-rank run")
    try:
        if dist.get_backend() != "nccl":
            raise RuntimeError(f"the card's process group runs {dist.get_backend()}, not NCCL")
        mesh = make_mesh(1)
        B, T_TEXT, T_MEL = 16, 128, 768
        text_lens = [T_TEXT - 4 * i for i in range(B)]
        mel_lens = [T_MEL - 24 * i for i in range(B)]
        batch = {k: torch.as_tensor(v, device=device) for k, v in fastpitch_batch(
            5, B, T_TEXT, T_MEL, 148, text_lens, mel_lens).items()}
        gan_batch = {"audio": torch.as_tensor((np.random.default_rng(6).standard_normal(
            (16, 8192, 1)) * 0.1).astype(np.float32), device=device)}
        steps, plain_ms = {}, {}
        for what in ("fastpitch", "gan"):
            for m in (None, mesh):
                if what == "fastpitch":
                    torch.manual_seed(0)
                    trainer = Trainer(make_loss_fn(FastPitchLossConfig(), 1),
                                      FastPitch(FastPitchConfig()), TrainerConfig(), device,
                                      mesh=m)
                    data, modules = batch, lambda t: [t.model]
                else:
                    trainer = HiFiGANTrainer(HiFiGANConfig.v1(), device, mesh=m)
                    data, modules = gan_batch, lambda t: [t.gen, t.mpd, t.msd]
                for fn in (b1, b2, mas):
                    fn.launches = 0
                # cuDNN's default backward algorithms sum in a run-dependent
                # order, and Adam's first step moves a parameter whose
                # gradient is near zero by up to lr whatever that gradient's
                # size (one element of the v1 generator's 2.1M moved 4.96e-5
                # between two plain-vs-mesh runs): the compared steps run
                # cuDNN's deterministic algorithms, the timed ones its defaults
                torch.backends.cudnn.deterministic = True
                try:
                    metrics = {k: float(v) for k, v in trainer.train_step(data).items()}
                finally:
                    torch.backends.cudnn.deterministic = False
                counts = (b1.launches, b2.launches, mas.launches)
                steps[what, m is not None] = (trainer, data, metrics,
                                              _state_arrays(modules(trainer)), counts)
            (_, _, m_plain, s_plain, _), (_, _, m_dp, s_dp, c_dp) = (
                steps[what, False], steps[what, True])
            want = (0, 0, 1) if what == "fastpitch" else (3, b2_launches_per_step(8192), 0)
            if c_dp != want:
                raise RuntimeError(f"{what} step on the mesh launched B1, B2, MAS {c_dp}, "
                                   f"not {want}")
            rel, worst = _held_to_plain(what, m_plain, m_dp, s_plain, s_dp)
            log(f"parallel (a): {what} step, NCCL world size 1, on a 1-rank mesh vs plain: "
                f"max metric rel err {rel:.2e}, max |param/buffer diff| {worst:.2e}; B1, B2, MAS "
                f"launches in the mesh's step {c_dp}")
            walls, reduce_host = {}, []
            all_reduce = FlatGrads.all_reduce_

            def timed_reduce(*args, **kwargs):  # the host's time in the flat all-reduce
                t = time.perf_counter()
                out = all_reduce(*args, **kwargs)
                reduce_host.append(time.perf_counter() - t)
                return out

            FlatGrads.all_reduce_ = timed_reduce
            try:
                for dp in (False, True, True, False):
                    trainer, data = steps[what, dp][:2]
                    w = timed_calls(torch, lambda: trainer.train_step(data), 3)[1]
                    walls.setdefault(dp, []).extend(w)
            finally:
                FlatGrads.all_reduce_ = all_reduce
            plain_ms[what] = float(np.median(walls[False])) * 1e3
            n_grads = sum(p.numel() for mod in modules(steps[what, True][0])
                          for p in mod.parameters())
            log(f"parallel (a): {what} step wall, plain / 1-rank mesh in 4 turns of 3: median "
                f"{np.median(walls[False]) * 1e3:.2f} / {np.median(walls[True]) * 1e3:.2f} ms "
                f"(runs {runs(walls[False])} / {runs(walls[True])}); the host in the mesh "
                f"step's one all-reduce of {n_grads:,} gradients: median "
                f"{np.median(reduce_host) * 1e3:.2f} ms [{card}]")
            if what == "gan":
                for dp in (False, True):
                    trainer, data = steps[what, dp][:2]
                    log(f"  trace (GAN step, {'1-rank mesh' if dp else 'plain'}): "
                        + trace_summary(torch, lambda: trainer.train_step(data),
                                        float(np.median(walls[dp]))))
                    log(f"  host: " + host_summary())
            for dp in (False, True):
                del steps[what, dp]
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    log(f"parallel (a): {time.perf_counter() - t_phase:.1f} s")

    t0 = time.perf_counter()
    results, _ = torch_parallel_check.run(2, ["fastpitch", "talknet", "gan", "tp"],
                                          device="cuda", backend="gloo", timeout=300)
    for r in results:
        if not torch_parallel_check.passed(r):
            raise RuntimeError(f"parallel (b): a sharded step missed its tolerance: {r}")
        want = {"fastpitch": {"B1": 0, "B2": 0, "MAS": 1},
                "gan": {"B1": 3, "B2": b2_launches_per_step(256), "MAS": 0}}.get(r["case"])
        if want is not None and r["launches"] != want:
            raise RuntimeError(f"parallel (b): rank {r['rank']}'s {r['case']} step launched "
                               f"{r['launches']}, not {want}")
    if len(results) != 10:
        raise RuntimeError(f"parallel (b): {len(results)} results, not 10")
    log(f"parallel (b): 2 gloo processes on cuda:0 ({time.perf_counter() - t0:.1f} s), each "
        f"case vs the one-process step as ratios to the tolerances (≤ 1 passes): " + "; ".join(
            f"{r['case']} rank {r['rank']} mesh {r['mesh']}: loss {r['loss']:.2e} grads "
            f"{r['grads']:.2e} params {r['params']:.2e} buffers {r['buffers']:.2e} (spread "
            f"over ranks {r['buffers_rank_spread']:.1e}) launches {r['launches']}"
            for r in results))

    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-u", str(ROOT / "tools" / "torch_cli_throughput.py"), "fastpitch",
         "--items", "4", "--list-repeat", "32", "--batch-size", "16", "--epochs", "2",
         "--steps-per-epoch", "8", "--precision", "f32", "--workdir",
         str(WORK / "cli_throughput"), "--device-ms", f"{plain_ms['fastpitch']:.1f}"],
        capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"torch_cli_throughput failed:\n{out.stdout[-3000:]}"
                           f"{out.stderr[-3000:]}")
    tail = [line for line in out.stdout.splitlines()
            if line.startswith(("fastpitch (f32) CLI loop", "steady state", "step on the card",
                                "prepared", "epoch"))]
    log(f"parallel (c): host-fed FastPitch CLI loop (tools/torch_cli_throughput.py, 4 wavs of "
        f"640-832 frames listed 32 times, batch 16, 2 epochs x 8 steps, f32; "
        f"{time.perf_counter() - t0:.1f} s) [{card}]: " + " | ".join(tail))
    log(f"parallel: the phase took {time.perf_counter() - t_phase:.1f} s")


def serving_models(torch, device):
    """The six text → mel families at full width with random weights from a
    seed, each as its serving loop's ``synthesize`` takes it, with the
    sentences each one's CLI front end encodes; and a HiFi-GAN v1."""
    from neuraltexttospeech_torch.cli import gradtts_infer
    from neuraltexttospeech_torch.cli.talknet_train import HEADS
    from neuraltexttospeech_torch.models.fastpitch import FastPitchConfig
    from neuraltexttospeech_torch.models.fastspeech2 import FastSpeech2, FastSpeech2Config
    from neuraltexttospeech_torch.models.flowtron import Flowtron, FlowtronConfig
    from neuraltexttospeech_torch.models.gradtts import GradTTSConfig
    from neuraltexttospeech_torch.models.hifigan import Generator, HiFiGANConfig
    from neuraltexttospeech_torch.models.tacotron2 import Tacotron2, Tacotron2Config
    from neuraltexttospeech_torch.models.talknet import TalkNet2Config
    from neuraltexttospeech_torch.text.processing import TextProcessing

    lines = SENTENCES[:8]
    v2 = TextProcessing("english_basic", ["english_cleaners_v2"], p_arpabet=0.0)
    basic = TextProcessing("english_basic", ["english_cleaners"], p_arpabet=0.0)
    encode = lambda tp: [np.asarray(tp.encode_text(l), np.int32) for l in lines]  # noqa: E731
    models = {"fastpitch": random_fastpitch(FastPitchConfig(), 0, device)}
    fs2 = random_init_(FastSpeech2(FastSpeech2Config()).to(device), 101, device).eval()
    heads = tuple(random_init_(cls(TalkNet2Config()).to(device), 102 + i, device).eval()
                  for i, cls in enumerate(HEADS.values()))
    fl = random_init_(Flowtron(FlowtronConfig()).to(device), 105, device).eval()
    # 400 decoder steps, Flowtron's frames here (1000 in the timing phase)
    t2 = random_init_(Tacotron2(Tacotron2Config(max_decoder_steps=400)).to(device), 106,
                      device).eval()
    with torch.no_grad():
        # every FastPitch duration exactly 6 frames, in f32 and in bf16 alike
        # (a random duration head's bf16 rounding moves some durations by a
        # frame, and the --amp run is held to the f32 run's lengths)
        models["fastpitch"].duration_predictor.fc.weight.zero_()
        fs2.duration_predictor.fc.bias.fill_(float(np.log(7.0)))
        heads[0].backbone.out.weight.zero_()  # every duration 6 frames
        heads[0].backbone.out.bias.fill_(6.0)
        fl.flows[1].gate_layer.bias.fill_(-50.0)  # no row stops: every row the same length
        t2.cell.gate_layer.bias.fill_(-50.0)
    models.update(fastspeech2=fs2, talknet=heads, flowtron=fl, tacotron2=t2,
                  gradtts=random_gradtts(GradTTSConfig(), 6, device, frames_per_token=3.0))
    encoded = {"fastpitch": encode(v2), "gradtts": gradtts_infer.encode(lines, 149)}
    for family in ("fastspeech2", "talknet", "flowtron", "tacotron2"):
        encoded[family] = encode(basic)
    gen = random_init_(Generator(HiFiGANConfig.v1()).to(device), 1, device).eval()
    return models, encoded, gen


def serve(family, model, gen, encoded, devices, dtype=None):
    """``family``'s ``synthesize`` over ``devices`` at batch 8 with its
    draws active (Grad-TTS's stochastic sampler, Flowtron's z at σ 0.8,
    Tacotron 2's prenet dropout): [(index, mel, audio)] in yield order."""
    from neuraltexttospeech_torch.cli import (fastpitch_infer, fastspeech2_infer, flowtron_infer,
                                              gradtts_infer, tacotron2_infer, talknet_infer)

    if family == "fastpitch":
        it = fastpitch_infer.synthesize(model, gen, encoded, device=devices, batch_size=8,
                                        max_mel_len=1024, dtype=dtype)
    elif family == "fastspeech2":
        it = fastspeech2_infer.synthesize(model, gen, encoded, device=devices, batch_size=8)
    elif family == "talknet":
        it = talknet_infer.synthesize(model, gen, encoded, device=devices, batch_size=8)
    elif family == "gradtts":
        it = (o[:3] for o in gradtts_infer.synthesize(model, gen, encoded, device=devices,
                                                      stoc=True, batch_size=8))
    elif family == "flowtron":
        it = flowtron_infer.synthesize(model, gen, encoded, device=devices, batch_size=8,
                                       n_frames=400, sigma=0.8)
    else:
        it = tacotron2_infer.synthesize(model, gen, encoded, device=devices, batch_size=8)
    return list(it)


def held_equal(what, one, two, atol, of_size=0.0):
    """Two serving runs' outputs: the same indices and lengths, mels and audio
    within ``atol`` (or ``of_size`` times the largest value of the first run,
    when that is more); returns the largest mel and audio differences."""
    if [j for j, _, _ in one] != [j for j, _, _ in two]:
        raise RuntimeError(f"{what}: the utterances came back in another order")
    e_mel = e_audio = 0.0
    for (j, mel1, audio1), (_, mel2, audio2) in zip(one, two):
        if mel1.shape != mel2.shape or audio1.shape != audio2.shape or not mel1.shape[0]:
            raise RuntimeError(f"{what} utterance {j}: mel {mel1.shape} vs {mel2.shape}, "
                               f"audio {audio1.shape} vs {audio2.shape}")
        if not (np.isfinite(mel2).all() and np.isfinite(audio2).all()):
            raise RuntimeError(f"{what} utterance {j}: non-finite output")
        e_mel = max(e_mel, float(np.abs(mel1 - mel2).max()))
        e_audio = max(e_audio, float(np.abs(audio1 - audio2).max()))
    tol = [max(atol, of_size * max(float(np.abs(o[k]).max()) for o in one)) for k in (1, 2)]
    if not (e_mel <= tol[0] and e_audio <= tol[1]):
        raise RuntimeError(f"{what}: mel {e_mel:.3e}, audio {e_audio:.3e} past "
                           f"{tol[0]:.3e}, {tol[1]:.3e}")
    return e_mel, e_audio


def phase_serving_replicas(torch, device, card):
    """Serving over several devices (``utils/serving.py``) on the one card.

    (a) The six serving loops (FastPitch, FastSpeech 2, TalkNet 2, Grad-TTS,
    Flowtron, Tacotron 2, each with HiFi-GAN v1, full width, random weights;
    Flowtron and Tacotron 2 over 400 frames) on the first 8 ``SENTENCES`` at
    batch 8, f32 with TF32 off, after a warm run of each: once on
    ``[cuda:0]`` and once on ``[cuda:0, cuda:0]`` (two replicas, two host
    threads), the draws active; the two runs hold the same indices and
    lengths, mels and audio within 1e-4 (cuBLAS and cuDNN may pick other
    algorithms at 4 rows than at 8; Grad-TTS's within 1e-5 of their size
    where that is more, as its CPU parity is held). FastPitch → v1 also with ``--amp`` on
    two replicas, held to the one-replica bf16 run by the bf16 yardstick (the
    one-replica runs in JAX's place) and differing from the f32 run. Each
    traced run's wall and the card's busy share are printed; two replicas
    share one card, so the walls are not a scaling figure. (b) The trace
    tools: ``tools/torch_trace_capture.py`` for ``hifigan_gan`` (bf16) and
    ``fastpitch_infer``, 3 steps each, B2 bf16 90 and B1 3 launches a GAN
    step in the trace (each run in a process of its own, as a user runs it),
    and ``tools/torch_trace_breakdown.py`` on the written Chrome trace
    reading the busy time the raw records give within 2 %. (c)
    ``tools/torch_audio_compare.py`` on a synthetic 10 s wav, B1 on the card
    within 1e-3 of the float64 oracle."""
    from neuraltexttospeech_torch.utils.profiling import breakdown
    from torch.profiler import ProfilerActivity, profile
    from tools import torch_audio_compare, torch_trace_breakdown

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    models, encoded, gen = serving_models(torch, device)
    one, two = [device], [device, device]

    def traced(family, devices, dtype=None):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = serve(family, models[family], gen, encoded[family], devices, dtype)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        b = breakdown(prof)
        return out, wall, b.busy_ms / 1e3 / wall

    results = {}
    for family in ("fastpitch", "fastspeech2", "talknet", "gradtts", "flowtron", "tacotron2"):
        for devices in (one, two):  # warm: algorithms at both batches, the threads' handles
            serve(family, models[family], gen, encoded[family], devices)
        out1, wall1, share1 = traced(family, one)
        out2, wall2, share2 = traced(family, two)
        # Grad-TTS's Euler steps scale the estimator's rounding, which other
        # conv algorithms at 4 rows than at 8 change: its mel (and the audio
        # of it) is held at 1e-5 of its size where that is more than 1e-4,
        # as its CPU parity is (ROADMAP §C)
        e_mel, e_audio = held_equal(f"{family}: 2 replicas vs 1", out1, out2, 1e-4,
                                    1e-5 if family == "gradtts" else 0.0)
        frames = sum(m.shape[0] for _, m, _ in out1)
        results[family] = out1
        log(f"serving replicas (a): {family} + v1, 8 sentences at batch 8, f32 (TF32 off), "
            f"{frames} frames: [cuda:0] vs [cuda:0, cuda:0] same order and lengths, max |diff| "
            f"mel {e_mel:.2e}, audio {e_audio:.2e}; traced wall 1 replica {wall1 * 1e3:.1f} ms "
            f"(card busy {share1:.3f}), 2 replicas on one card {wall2 * 1e3:.1f} ms (busy "
            f"{share2:.3f}); not a scaling figure: both replicas share the one card [{card}]")
    for devices in (one, two):
        serve("fastpitch", models["fastpitch"], gen, encoded["fastpitch"], devices,
              torch.bfloat16)
    bf16_one, wall1, share1 = traced("fastpitch", one, torch.bfloat16)
    bf16_two, wall2, share2 = traced("fastpitch", two, torch.bfloat16)
    if [(j, m.shape) for j, m, _ in bf16_one] != [(j, m.shape) for j, m, _ in bf16_two]:
        raise RuntimeError("fastpitch --amp: 2 replicas gave other lengths than 1")
    if [m.shape for _, m, _ in bf16_one] != [m.shape for _, m, _ in results["fastpitch"]]:
        raise RuntimeError("fastpitch --amp: other lengths than f32")
    flat = lambda out, k: np.concatenate([o[k].ravel() for o in out])  # noqa: E731
    errs = [bf16_yardstick(f"fastpitch --amp {what}, 2 replicas vs 1", flat(bf16_two, k),
                           flat(bf16_one, k), flat(results["fastpitch"], k))
            for k, what in ((1, "mel"), (2, "audio"))]
    off_f32 = float(np.abs(flat(bf16_two, 1) - flat(results["fastpitch"], 1)).max())
    if not off_f32 > 1e-3:
        raise RuntimeError(f"fastpitch --amp on 2 replicas is {off_f32:.2e} from the f32 run: "
                           "bf16 did not run in the threads")
    log(f"serving replicas (a): fastpitch + v1 --amp: 2 replicas vs 1 mel {errs[0][0]:.2e}, "
        f"audio {errs[1][0]:.2e} (1 replica bf16 vs f32 {errs[0][1]:.2e}, {errs[1][1]:.2e}: "
        f"within the bf16 yardstick); 2 replicas' bf16 mel vs f32 {off_f32:.2e}; traced wall "
        f"1 replica {wall1 * 1e3:.1f} ms (busy {share1:.3f}), 2 replicas on one card "
        f"{wall2 * 1e3:.1f} ms (busy {share2:.3f}) [{card}]")
    del models, results
    torch.cuda.empty_cache()
    t_b = time.perf_counter()

    for case, amp in (("hifigan_gan", True), ("fastpitch_infer", False)):
        # the tool in a process of its own, as a user runs it: in this
        # long-lived process the profiler lost the first ~40 device records
        # of every 3-step GAN trace (2 of its 9 B1 launches), in a fresh one
        # none
        out, t0 = WORK / f"trace_{case}", time.perf_counter()
        run = subprocess.run([sys.executable, str(ROOT / "tools" / "torch_trace_capture.py"),
                              case, "--steps", "3", "--top", "8", "--out", str(out)]
                             + (["--amp"] if amp else []),
                             capture_output=True, text=True, timeout=600)
        text = "\n".join(line for line in run.stdout.splitlines() if not line.startswith("USDT"))
        if run.returncode != 0:
            raise RuntimeError(f"tools/torch_trace_capture.py {case} failed:\n{text[-3000:]}"
                               f"{run.stderr[-3000:]}")
        log(f"serving replicas (b): python tools/torch_trace_capture.py {case}"
            f"{' --amp' if amp else ''} --steps 3 ({time.perf_counter() - t0:.1f} s) "
            f"[{card}]:\n{text}")
        raw_busy = float(text.split("card busy ", 1)[1].split(" ms/step", 1)[0])
        c = torch_trace_breakdown.summarize(str(out), steps=3, top=3)
        if abs(c.busy_ms / c.steps - raw_busy) > 0.02 * raw_busy:
            raise RuntimeError(f"{case}: the Chrome trace reads busy {c.busy_ms / c.steps:.3f} "
                               f"ms a step, the raw records {raw_busy:.3f}")
        traced = tuple(sum(n for name, (_, n) in c.kernels.items() if key in name) / c.steps
                       for key in (B2_MAIN_KERNELS[1], "logmel_fft_kernel"))
        want = (b2_launches_per_step(8192), 3) if case == "hifigan_gan" else (0, 0)
        if traced != want:
            raise RuntimeError(f"the traced {case} launched B2 bf16, B1 {traced} a step, not "
                               f"{want}")
        log(f"  B2 bf16 {traced[0]:g} and B1 {traced[1]:g} launches a step in the trace; "
            f"tools/torch_trace_breakdown.py reads busy {c.busy_ms / c.steps:.3f} ms a step, "
            f"the raw records {raw_busy:.3f}")
    t_c = time.perf_counter()
    res = torch_audio_compare.main(["--seed", "0", "--out", str(WORK / "audio_compare")])
    log(f"serving replicas (c): tools/torch_audio_compare.py, 10 s synthetic wav "
        f"({res['frames']} frames): plain vs float64 L1 {res['pairs']['plain', 'float64'][0]:.2e} "
        f"Linf {res['pairs']['plain', 'float64'][1]:.2e}, B1 on the card vs float64 L1 "
        f"{res['pairs']['B1', 'float64'][0]:.2e} Linf {res['pairs']['B1', 'float64'][1]:.2e} "
        f"(budget 1e-3) [{card}]")
    log(f"serving replicas: (a) {t_b - t_phase:.1f} s, (b) {t_c - t_b:.1f} s, (c) "
        f"{time.perf_counter() - t_c:.1f} s")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import neuraltexttospeech_torch  # noqa: F401  (fails outside the repo)

    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    try:
        build_kernels()
        phase_gpu_tests()
        b1 = phase_kernels(torch, device, smi)
        b2 = phase_tap_dots(torch, device, smi)
        b2_bf16 = phase_tap_dots(torch, device, smi, dtype="bf16")
        mas = phase_mas(torch, device, smi)
        serving = phase_serving(torch, device)
        train = phase_training(torch, device, smi)
        train_bf16 = phase_training(torch, device, smi, amp=True)
        phase_fine_tuning(torch, device, smi)
        fastpitch = phase_fastpitch_training(torch, device, smi)
        diffwave_b1 = phase_diffwave_cli(torch, device, smi)
        phase_gradtts_serve(torch, device, smi)
        gradtts = phase_gradtts_train_cli(torch, device, smi)
        fs2_b1 = phase_fastspeech2_cli(torch, device, smi)
        talknet_b1 = phase_talknet_cli(torch, device, smi)
        t2_b1 = phase_tacotron2_cli(torch, device, smi)
        fl_b1 = phase_flowtron_cli(torch, device, smi)
        tools_mas = phase_tools_cli(torch, device, smi)
        # launches per step on the training paths (B1 and B2: the GAN step,
        # f32 and bf16; MAS: the FastPitch step, and the Grad-TTS step's
        # checked equal); serving's and dataset prep's B1 counts are checked
        # in their phases
        b1["launches"], b2["launches"] = train["b1_per_step"], train["b2_per_step"]
        b2_bf16["launches"] = train_bf16["b2_per_step"]
        mas["launches"] = fastpitch["f32"]["mas_per_step"]
        if gradtts["f32"]["mas_per_step"] != mas["launches"]:
            raise RuntimeError(f"MAS per Grad-TTS step {gradtts['f32']['mas_per_step']}, per "
                               f"FastPitch step {mas['launches']}")
        log(f"B1 launches: serving path {serving}, GAN training path {train['b1']} (bf16 "
            f"{train_bf16['b1']}), FastPitch dataset prep {fastpitch['b1_prep']}, FastSpeech 2 "
            f"prep {fs2_b1}, Tacotron 2 prep {t2_b1}, Flowtron prep {fl_b1}; B2 launches: GAN "
            f"training f32 {train['b2']}, bf16 "
            f"{train_bf16['b2']}; MAS launches: FastPitch training f32 "
            f"{fastpitch['f32']['mas']}, bf16 {fastpitch['bf16']['mas']}, Grad-TTS training "
            f"f32 {gradtts['f32']['mas']}, bf16 {gradtts['bf16']['mas']} (3 steps and 3 "
            f"validation batches each), "
            + ", ".join(f"{k} {v}" for k, v in tools_mas.items())
            + f" (16 utterances in 2 batches each); B1 launches per DiffWave training batch "
            f"{diffwave_b1}, TalkNet 2 ASR training {talknet_b1} (3 epochs of 16 utterances)")
        phase_reference(torch, device)
        phase_gan_reference(torch, device)
        phase_fastpitch_reference(torch, device)
        phase_diffwave_reference(torch, device)
        phase_gradtts_reference(torch, device)
        phase_gradtts_train_reference(torch, device)
        phase_fastspeech2_reference(torch, device)
        phase_talknet_reference(torch, device)
        phase_tacotron2_reference(torch, device)
        phase_flowtron_reference(torch, device)
        phase_timing(torch, device, smi)
        phase_train_timing(torch, train["trainer"], smi)
        phase_train_timing(torch, train_bf16["trainer"], smi)
        del train, train_bf16, fastpitch
        phase_fastpitch_timing(torch, device, smi)
        phase_fastpitch_timing(torch, device, smi, amp=True)
        phase_diffwave_timing(torch, device, smi)
        phase_gradtts_bench(torch, device, smi)
        for amp in (False, True):
            phase_gradtts_train_timing(torch, device, smi, amp)
            phase_fastspeech2_train_timing(torch, device, smi, amp)
        phase_talknet_timing(torch, device, smi)
        phase_tacotron2_timing(torch, device, smi)
        phase_flowtron_timing(torch, device, smi)
        phase_parallel(torch, device, smi)
        phase_serving_replicas(torch, device, smi)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"kernels": [b1, b2, b2_bf16, mas]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
