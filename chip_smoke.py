#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``neuraltexttospeech_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of the repository

Phases, each raising on failure:

1. Device: the card's name and power limit.
2. Kernels: build the three kernels from ``ops/csrc`` (one ``nvcc`` each,
   at once), hold each against its plain PyTorch twin on the card (TF32 off)
   and time the kernel, the twin and the PyTorch library call for the same
   function, by device time (the profiler's kernel time) and by CUDA events
   over back-to-back calls (which include the host's dispatch): B1 (log-mel)
   forward and its analytic backward; B2 (the MSD's tap-window grouped GEMM)
   at every distinct MSD shape of a v1 GAN step, forward and dx, in its f32
   (3xTF32) and its bf16 form, each beside grouped ``F.conv1d`` in the same
   type, with an ``HGMMA`` check of both forms' SASS; MAS (monotonic
   alignment search, bit for bit) at 16 × 768 × 128 and 16 × 870 × 192.
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
6. Reference checks: at a small width the card's text → wav and
   copy-synthesis agree with the same weights on the CPU, and so do one
   GAN step of the small (``TINY``) generator with the full MPD and MSD and
   one FastPitch train step of the golden's small FastPitch (dropout off),
   each in f32 and in bf16 (bf16 by the yardstick of tests/test_torch_bf16.py
   with the CPU's f32 step in the place of JAX's).
7. Timing: text → wav at the ``bench.py`` shape (batch 8 × 128 tokens,
   1024 mel frames), f32 and bf16, in wall seconds per audio second; the v1
   GAN step in ms and samples/s, and the FastPitch train step at the
   ``bench.py`` shape (16 × 128 tokens × 768 frames) in ms and mel frames/s,
   each f32 and bf16 with a profiler split, idle share and launch count.

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
    # HGMMA (wgmma) instructions in each main-kernel instantiation: the f32
    # form (Tf32x3, .tf32 operands) and the bf16 form (Bf16, .bf16 operands)
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif "HGMMA" in line and fn and "tap_dots_tc_kernel" in fn:
            counts[fn] = counts.get(fn, 0) + 1
    for form in ("Tf32x3", "Bf16"):
        n = sum(c for name, c in counts.items() if form in name)
        log(f"B2's {form} instantiations hold {n} HGMMA (wgmma) instructions in their SASS")
        if not n:
            raise RuntimeError(f"B2's {form} form was compiled without wgmma: no HGMMA")


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
    # the training path's: 16 reflect-padded 8192-sample crops (512 frames)
    one = torch.nn.functional.pad(wavs[:1, None], (pad, pad), mode="reflect")[0, 0]
    crops = torch.nn.functional.pad(wavs[:, None, :8192], (pad, pad), mode="reflect")[:, 0]
    shapes = {"one_wav": one, "train_16x8192": crops, "batch_8x10s": wavs[:8]}
    record = None
    for label, x in shapes.items():
        frames = windowed_frames(x, 1024, HOP, 1024).reshape(-1, 1024).contiguous()
        n = frames.shape[0]
        assert n == x.numel() // x.shape[-1] * num_frames(x.shape[-1], 1024, HOP)
        err = 0.0
        for power in (0.5, 2.0):
            cfg = STFTConfig(magnitude_power=power)
            got = mel_kernel.fused_frames_to_mel(frames, cfg)
            want = mel_kernel.frames_to_mel_reference(frames, cfg)
            torch.cuda.synchronize()
            d = (got - want).abs().max().item()
            log(f"B1 {label} N={n} p={power}: max|kernel - plain| = {d:.3e}")
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


# kernel names of B2 in a profile (its main kernel, prologue and split-K sum)
B2_KERNELS = ("tap_dots_tc_kernel", "pack_weights_kernel", "sum_splits_kernel")


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
    totals = dict.fromkeys(keys, 0.0)
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
            tile = gouter_kernel.plan_tiles(g, b * q, y_dim,
                                            kf * x_dim // gouter_kernel.k_block(xp.dtype),
                                            torch.cuda.get_device_properties(device)
                                            .multi_processor_count)
            log(f"B2 {dtype} scale {scale} layer {layer} {kind} (g={g}, B={b}, Qp={qp}, X={x_dim}, "
                f"Y={y_dim}, kf={kf}, s={s}, q={q}; tile {64 * tile[0]}x{tile[1]}, "
                f"{tile[2]} K splits): max|kernel - plain| {d:.3e} ({d / scale_y:.1e} of "
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
        + (f", max excess over one bf16 ulp {worst_excess:.3e}" if bf16 else "") + f" [{card}]")
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


def phase_mas(torch, device, card):
    """MAS: the kernel against its plain twin on the card (bit for bit) at
    the ``bench.py`` FastPitch shape (16 × 768 mel frames × 128 tokens) and
    at 16 copies of the longest LJSpeech clip (870 × 192), timed beside the
    twin and the bound. Returns the JSON record (the first shape)."""
    from neuraltexttospeech_torch.ops import mas_kernel

    record = None
    for b, t_mel, t_text in ((16, 768, 128), (16, 870, 192)):
        gen = torch.Generator(device=device).manual_seed(t_mel)
        la = torch.log_softmax(torch.randn(b, t_mel, t_text, device=device, generator=gen), -1)
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
        dev = {"kernel": device_ms(torch, fns["kernel"], reps=10)}
        # the MAS kernel's own time, from the same trace of 10 calls
        own = sum(ms for ms, name in device_breakdown.last if "mas_kernel" in name) / 10
        dev["plain"] = device_ms(torch, fns["plain"], reps=2)
        bound_ms, bound_by = mas_bound_ms(b, t_mel, t_text, [t_mel] * b)
        log(f"MAS {b}x{t_mel}x{t_text}: kernel == twin bit for bit; device time kernel "
            f"{dev['kernel'] * 1e3:.2f} us (the MAS kernel itself {own * 1e3:.2f} us, the rest "
            f"the wrapper's zero fill of the path), plain loop {dev['plain'] * 1e3:.1f} us; CUDA "
            f"events over back-to-back calls kernel {ev['kernel'] * 1e3:.2f} us, plain "
            f"{ev['plain'] * 1e3:.1f} us; bound {bound_ms * 1e3:.2f} us ({bound_by}), {bound_ms / dev['kernel']:.1%} of it "
            f"reached; {t_mel} dependent rows, {dev['kernel'] / t_mel * 1e6:.1f} ns a row [{card}]")
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
        for counted in (mel_kernel.fused_frames_to_mel, gouter_kernel.gouter_tap_dots_kernel,
                        mas_kernel.maximum_path):
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


def check_bf16_step(label, metrics, params, grads, lr):
    """A bf16 train step card vs CPU: metrics by :func:`bf16_yardstick`; the
    gradients by it too, as tests/test_torch_bf16.py's ``grads_yardstick``
    holds them against JAX (the whole gradient as one tensor, and the median
    over parameters of each one's |card - CPU| over its own bound);
    parameters within 2.5 lr + 1e-6 (an Adam step is about lr sign(g), so
    this bound alone would hold any gradient). ``metrics``/``params``/
    ``grads`` map (amp, device type) to the step's outputs."""
    worst_m = {}
    for k, v in metrics[(False, "cpu")].items():
        worst_m[k] = bf16_yardstick(f"{label} {k}", metrics[(True, "cuda")][k],
                                    metrics[(True, "cpu")][k], v)
    ratios, e = [], np.zeros(3)
    for k, v in grads[(False, "cpu")].items():
        card, cb, cf = (t.double() for t in (grads[(True, "cuda")][k], grads[(True, "cpu")][k], v))
        leaf = np.array([(card - cb).abs().max().item(), (cb - cf).abs().max().item(),
                         cf.abs().max().item()])
        e = np.maximum(e, leaf)
        bound = 2 * leaf[1] + 1e-3 * leaf[2]
        ratios.append((leaf[0] / bound if bound > 0 else float(leaf[0] > 0), k))
    median = float(np.median([r for r, _ in ratios]))
    if e[0] > 2 * e[1] + 1e-3 * e[2] or median > 1.0:
        raise RuntimeError(f"bf16 {label} gradients: card vs CPU {e[0]:.3e} (CPU bf16 vs f32 "
                           f"{e[1]:.3e}), median over parameters {median:.2f} of the bound")
    worst_p = 0.0
    for k, v in params[(True, "cpu")].items():
        d = (params[(True, "cuda")][k].double() - v.double()).abs().max().item()
        if ".sn." in k:  # spectral-norm stats: f32 from f32 weights in both modes
            np.testing.assert_allclose(params[(True, "cuda")][k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
        elif d > 2.5 * lr + 1e-6:
            raise RuntimeError(f"bf16 {label} parameter {k}: card vs CPU {d:.3e} > 2.5 lr")
        worst_p = max(worst_p, d)
    worst = max(ratios)
    log(f"reference: {label} bf16 card vs CPU: metrics (|card - CPU|, CPU bf16 vs f32) "
        + ", ".join(f"{k} {a:.2e}/{b:.2e}" for k, (a, b) in sorted(worst_m.items()))
        + f"; gradients {e[0]:.2e}/{e[1]:.2e} (bound {2 * e[1] + 1e-3 * e[2]:.2e}), median "
        f"{median:.2f} of each parameter's bound, {sum(r > 1 for r, _ in ratios)} of "
        f"{len(ratios)} past it, the farthest {worst[1]} ({worst[0]:.2f}); max|param diff| "
        f"{worst_p:.2e} (bound {2.5 * lr + 1e-6:.2e})")


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
    from neuraltexttospeech_torch.train.harness import Trainer, TrainerConfig
    from neuraltexttospeech_torch.train.state import OptimizerConfig

    no_dropout = {f.name: 0.0 for f in dataclasses.fields(FastPitchConfig)
                  if f.name.startswith("p_")}
    cfg = FastPitchConfig(**FP_TINY, **no_dropout)
    torch.manual_seed(3)
    weights = FastPitch(cfg).state_dict()
    batch = fastpitch_batch(4, 3, 16, 48, 40, [16, 10, 6], [48, 37, 20])
    cpu = torch.device("cpu")
    out, steps = {}, {}
    for amp in (False, True):
        for dev in (device, cpu):
            model = FastPitch(cfg)
            model.load_state_dict(weights)
            trainer = Trainer(make_loss_fn(FastPitchLossConfig(), 1), model,
                              TrainerConfig(optimizer=OptimizerConfig(learning_rate=1e-3,
                                                                      eps=1e-6)), dev,
                              dtype=torch.bfloat16 if amp else None)
            metrics = trainer.train_step({k: torch.as_tensor(v, device=dev)
                                          for k, v in batch.items()})
            # the first Adam moment after one step is (1 - b1) g
            b1 = trainer.optimizer.config.beta1
            names = [n for n, p in model.named_parameters() if p.requires_grad]
            steps[(amp, dev.type)] = ({k: float(v) for k, v in metrics.items()},
                                      {k: v.detach().cpu() for k, v in model.state_dict().items()},
                                      {n: (m / (1.0 - b1)).cpu()
                                       for n, m in zip(names, trainer.optimizer.mu)})
    out = {dev: steps[(False, dev)] for dev in ("cuda", "cpu")}
    check_bf16_step("small FastPitch train step", *({k: v[i] for k, v in steps.items()}
                                                    for i in range(3)), 1e-3)
    worst_m = max(abs(out["cuda"][0][k] - v) / max(abs(v), 1e-12) for k, v in out["cpu"][0].items())
    for k, v in out["cpu"][0].items():
        np.testing.assert_allclose(out["cuda"][0][k], v, rtol=2e-4, err_msg=k)
    worst_p = 0.0
    for k, v in out["cpu"][1].items():
        np.testing.assert_allclose(out["cuda"][1][k].numpy(), v.numpy(), rtol=3e-3, atol=3e-5,
                                   err_msg=k)
        worst_p = max(worst_p, (out["cuda"][1][k] - v).abs().max().item())
    log(f"reference: small FastPitch train step card vs CPU: max relative metric diff "
        f"{worst_m:.2e}, max|param diff| {worst_p:.2e}")


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
    that took most time, as ``[(ms, name)]``. Every kernel's summed time, the
    sum over all of them and the number of device events stay on
    ``device_breakdown.last``, ``.kernel_sum`` and ``.launches``, each
    kernel's count on ``.counts``, the host's CUDA runtime calls on
    ``.runtime`` and its aten ops' counts on ``.ops``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def on_device(e):  # GPU user annotations are ranges, not kernels
        return e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)

    events = [e for e in prof.key_averages() if on_device(e)]
    kernels = [(e.self_device_time_total / 1e3, e.key) for e in events]
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in prof.events() if on_device(e)):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    device_breakdown.last = kernels
    device_breakdown.kernel_sum = sum(ms for ms, _ in kernels)
    device_breakdown.launches = sum(e.count for e in events)
    device_breakdown.counts = {e.key: e.count for e in events}
    device_breakdown.ops = {e.key: e.count for e in prof.key_averages()
                            if e.device_type != DeviceType.CUDA and e.key.startswith("aten::")}
    device_breakdown.runtime = {  # host side: CUDA runtime calls, (count, ms)
        e.key: (e.count, e.self_cpu_time_total / 1e3) for e in prof.key_averages()
        if e.device_type != DeviceType.CUDA and e.key.startswith(("cuda", "cu"))}
    return busy / 1e3, sorted(kernels, reverse=True)[:top]


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
    # B2's time counts its main kernel and its prologue, each once per call
    per_step = b2_launches_per_step(cfg.segment_size)
    for kernel in B2_KERNELS[:2]:
        n = sum(c for name, c in device_breakdown.counts.items() if kernel in name)
        if n != per_step:
            raise RuntimeError(f"the traced {mode} GAN step ran {kernel} {n} times, not "
                               f"{per_step}: B2's time would be misread")
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
        b1 = phase_kernels(torch, device, smi)
        b2 = phase_tap_dots(torch, device, smi)
        b2_bf16 = phase_tap_dots(torch, device, smi, dtype="bf16")
        mas = phase_mas(torch, device, smi)
        serving = phase_serving(torch, device)
        train = phase_training(torch, device, smi)
        train_bf16 = phase_training(torch, device, smi, amp=True)
        phase_fine_tuning(torch, device, smi)
        fastpitch = phase_fastpitch_training(torch, device, smi)
        # launches per step on the training paths (B1 and B2: the GAN step,
        # f32 and bf16; MAS: the FastPitch step); serving's and dataset
        # prep's B1 counts are checked in their phases
        b1["launches"], b2["launches"] = train["b1_per_step"], train["b2_per_step"]
        b2_bf16["launches"] = train_bf16["b2_per_step"]
        mas["launches"] = fastpitch["f32"]["mas_per_step"]
        log(f"B1 launches: serving path {serving}, GAN training path {train['b1']} (bf16 "
            f"{train_bf16['b1']}), FastPitch dataset prep {fastpitch['b1_prep']}; B2 launches: "
            f"GAN training f32 {train['b2']}, bf16 {train_bf16['b2']}; MAS launches: FastPitch "
            f"training f32 {fastpitch['f32']['mas']}, bf16 {fastpitch['bf16']['mas']}")
        phase_reference(torch, device)
        phase_gan_reference(torch, device)
        phase_fastpitch_reference(torch, device)
        phase_timing(torch, device, smi)
        phase_train_timing(torch, train["trainer"], smi)
        phase_train_timing(torch, train_bf16["trainer"], smi)
        del train, train_bf16, fastpitch
        phase_fastpitch_timing(torch, device, smi)
        phase_fastpitch_timing(torch, device, smi, amp=True)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"kernels": [b1, b2, b2_bf16, mas]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
