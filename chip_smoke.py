#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``neuraltexttospeech_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of the repository

Phases, each raising on failure:

1. Device: the card's name and power limit.
2. Kernels: build every kernel of the serving path from ``ops/csrc``, hold
   each against its plain PyTorch twin on the card (TF32 off) and time the
   kernel, the twin and the PyTorch library call for the same function.
3. Main path, through the two serving CLIs with full-width FastPitch and
   HiFi-GAN v1 (random weights from a seed): text → wav for 16 sentences,
   then wav → wav copy-synthesis, whose log-mels go through the kernel. The
   kernel launch counts are zeroed just before and read just after.
4. Reference check at a small width: the card's text → wav and
   copy-synthesis agree with the same weights run on the CPU.
5. Timing: text → wav at the ``bench.py`` shape (batch 8 × 128 tokens,
   1024 mel frames), f32 and bf16 autocast, in wall seconds per audio second.

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


def phase_kernels(torch, device, card):
    """Build, hold against the plain twin, time. Returns the JSON record."""
    from neuraltexttospeech_torch.audio.stft import STFTConfig, num_frames, windowed_frames
    from neuraltexttospeech_torch.ops import _build, mel_kernel

    t0 = time.perf_counter()
    _build.load(mel_kernel.SOURCE)
    log(f"kernels built: mel_kernel.fused_frames_to_mel "
        f"({time.perf_counter() - t0:.1f} s)")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tol = dict(atol=1e-3, rtol=1e-4)  # tests/test_audio.py's log-mel budget
    pad = (1024 - HOP) // 2
    wavs = torch.as_tensor(synthetic_wavs(8, 10.0, seed=0), device=device)
    # the main path's call: one reflect-padded 10 s wav (copy-synthesis)
    one = torch.nn.functional.pad(wavs[:1, None], (pad, pad), mode="reflect")[0, 0]
    shapes = {"one_wav": one, "batch_8x10s": wavs}
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
        iters = 50 if n < 2000 else 20
        ms = cuda_ms(lambda: mel_kernel.fused_frames_to_mel(frames, cfg), iters)
        plain_ms = cuda_ms(lambda: mel_kernel.frames_to_mel_reference(frames, cfg), iters)
        library_ms = cuda_ms(library, iters)
        bound_ms, bound_by, dft_bound_ms = logmel_bound_ms(n, cfg)
        log(f"B1 {label} N={n}: kernel {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, "
            f"torch.stft path {library_ms * 1e3:.1f} us; bound {bound_ms * 1e3:.2f} us "
            f"({bound_by}; rFFT + sparse mel), {bound_ms / ms:.2%} of it reached; "
            f"bound of the DFT-matmul form {dft_bound_ms * 1e3:.1f} us, "
            f"{dft_bound_ms / ms:.1%} of it reached [{card}]")
        if label == "one_wav":
            record = {"name": "mel_kernel.fused_frames_to_mel", "route": "cuda",
                      "source": "neuraltexttospeech_torch/ops/csrc/mel_kernel.cu",
                      "replaces": "neuraltexttospeech_tpu/ops/mel_kernel.py:163",
                      "launches": None, "max_abs_err": err, "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": library_ms}
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


def phase_main_path(torch, device):
    """Both serving entry points at full width. Returns B1's launch count."""
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

    mel_kernel.fused_frames_to_mel.launches = 0
    t0 = time.perf_counter()
    fastpitch_infer.main(["--checkpoint", str(fp_dir), "--hifigan-checkpoint", str(hg_dir),
                          "-i", str(text_file), "-o", str(WORK / "text2wav")])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    hifigan_infer.main(["--checkpoint", str(hg_dir), "-i", str(filelist),
                        "-o", str(WORK / "copysyn")])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = mel_kernel.fused_frames_to_mel.launches

    check_text2wav_outputs(WORK / "text2wav", len(SENTENCES))
    from scipy.io import wavfile

    pad = (1024 - HOP) // 2
    for i, w in enumerate(wavs):
        _, audio = wavfile.read(WORK / "copysyn" / f"synth_{i}.wav")
        assert audio.shape == (num_frames(w.size + 2 * pad, 1024, HOP) * HOP,), audio.shape
    log(f"main path: text->wav {len(SENTENCES)} sentences {t1 - t0:.2f} s, "
        f"copy-synthesis {len(wavs)} x 10 s {t2 - t1:.2f} s (first calls, "
        f"checkpoint load included); B1 launches {launches}")
    if launches != len(wavs):
        raise RuntimeError(f"copy-synthesis launched the log-mel kernel {launches} "
                           f"times for {len(wavs)} wavs")
    return launches


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
    """One traced call of ``fn``: total kernel time on the card (ms) and the
    kernels that took most of it, as ``[(ms, name)]``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [(e.self_device_time_total / 1e3, e.key) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    return sum(ms for ms, _ in kernels), sorted(kernels, reverse=True)[:top]


def phase_timing(torch, device, card):
    """text → wav at bench.py's shape: batch 8 × 128 tokens, 1024 frames."""
    from neuraltexttospeech_torch.models.fastpitch import FastPitchConfig
    from neuraltexttospeech_torch.models.hifigan import Generator, HiFiGANConfig

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
            with torch.inference_mode(), torch.autocast("cuda", torch.bfloat16, enabled=amp):
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
        with torch.inference_mode(), torch.autocast("cuda", torch.bfloat16, enabled=amp):
            fp_ms = cuda_ms(lambda: fp.infer(text, lens, max_mel_len=MAX_MEL), 3)
            gen_ms = cuda_ms(lambda: gen(mel), 3)
        name = "bf16 autocast" if amp else "f32 (TF32 off)"
        log(f"text->wav {name}: batch {B}x{T_TEXT} tokens, {MAX_MEL} frames = "
            f"{audio_s:.3f} s audio: wall {wall:.4f} s (runs {', '.join(f'{w:.4f}' for w in walls)}) "
            f"= {wall / audio_s:.3e} s per audio s; FastPitch {fp_ms:.2f} ms, "
            f"generator {gen_ms:.2f} ms; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
            f"[{card}]")
        busy, top = device_breakdown(torch, run)
        log(f"  trace: kernels {busy:.2f} ms of {wall * 1e3:.2f} ms wall, idle share "
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
    log(f"  trace: kernels {busy:.2f} ms of {wall * 1e3:.2f} ms wall, idle share "
        f"{1 - busy / (wall * 1e3):.3f}; top: "
        + "; ".join(f"{ms:.2f} ms {name[:70]}" for ms, name in top))


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
        record = phase_kernels(torch, device, smi)
        record["launches"] = phase_main_path(torch, device)
        phase_reference(torch, device)
        phase_timing(torch, device, smi)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
