"""Fused wav→log-mel: the CUDA kernel for Hopper and its plain PyTorch twin.

Counterpart of ``neuraltexttospeech_tpu/ops/mel_kernel.py`` (the Pallas
kernel ``fused_frames_to_mel``, ``pallas_call`` at :163), which computes

    mag² = (frames @ Dr)² + (frames @ Di)²       (the rDFT as two products)
    mel  = mag^p @ M
    out  = log(clip(mel, 1e-5))

``csrc/mel_kernel.cu`` computes the same function in one launch with a real
FFT in shared memory and a sparse (CSR) mel basis (its design and bound are
in that file); the host builds its twiddle table and CSR basis here
(:func:`_twiddles`, :func:`_csr_mel_basis`). :func:`frames_to_mel_reference`
is the dense chain above in torch ops; :func:`fused_frames_to_mel` takes it
only for a CPU tensor. For a CUDA tensor it launches the kernel or raises:
the kernel takes n_fft in :data:`FFT_LENGTHS` and any mel count.

:func:`fused_frames_to_mel` is differentiable. Its backward is the analytic
VJP ``_mel_bwd`` of the JAX module (:75-114), which is plain XLA there and
plain PyTorch here: f32 matmuls (TF32 off) against the same constants on both
devices, recomputing the spectrum from the frames. It passes no gradient
below the clip or where ``|X|^2 = 0``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import numpy as np
import torch

from ..audio.stft import STFTConfig, windowed_frames
from . import _build

__all__ = ["fused_mel_spectrogram", "fused_frames_to_mel", "frames_to_mel_backward",
           "frames_to_mel_reference", "SOURCE"]

SOURCE = "mel_kernel.cu"
FFT_LENGTHS = (64, 256, 1024)  # n_fft the kernel is instantiated for


@functools.lru_cache(maxsize=8)
def _dft_constants(fft_length: int):
    """Real/imag rDFT matrices [fft_length, fft_length/2 + 1], built in
    float64 and cast to float32."""
    k = np.arange(fft_length, dtype=np.float64)[:, None]
    f = np.arange(fft_length // 2 + 1, dtype=np.float64)[None, :]
    angle = -2.0 * np.pi * k * f / fft_length
    return np.cos(angle).astype(np.float32), np.sin(angle).astype(np.float32)


def _power(mag_sq: torch.Tensor, power: float) -> torch.Tensor:
    """|X|^p from |X|²: p/2 == 1 takes no root, p/2 == 0.5 a sqrt."""
    half_p = power / 2.0
    if half_p == 1.0:
        return mag_sq
    if half_p == 0.5:
        return torch.sqrt(mag_sq)
    return torch.pow(mag_sq, half_p)


@functools.lru_cache(maxsize=8)
def _reference_constants(config: STFTConfig, device: torch.device):
    """Dr, Di and M on ``device`` for the plain twin and the backward."""
    dr, di = _dft_constants(config.filter_length)
    return tuple(torch.as_tensor(a, device=device) for a in (dr, di, config.mel_basis()))


def frames_to_mel_reference(frames: torch.Tensor,
                            config: STFTConfig = STFTConfig()) -> torch.Tensor:
    """Plain twin of the kernel: windowed frames [N, fft_length] -> log-mel
    [N, n_mel_channels], as f32 ``torch.matmul``s against the dense DFT
    matrices and filterbank."""
    dr, di, basis = _reference_constants(config, frames.device)
    frames = frames.float()
    re = torch.matmul(frames, dr)
    im = torch.matmul(frames, di)
    mel = torch.matmul(_power(re * re + im * im, config.magnitude_power), basis)
    return torch.log(torch.clamp(mel, min=1e-5))


@functools.lru_cache(maxsize=8)
def _twiddles(fft_length: int) -> np.ndarray:
    """``exp(-2*pi*i*k/fft_length)`` for ``k <= fft_length/2`` as [k, (re, im)],
    built in float64 and cast to float32."""
    k = np.arange(fft_length // 2 + 1, dtype=np.float64)
    angle = -2.0 * np.pi * k / fft_length
    return np.stack([np.cos(angle), np.sin(angle)], axis=-1).astype(np.float32)


def _csr_mel_basis(basis: np.ndarray):
    """The filterbank [n_bins, n_mels] in the kernel's sparse form: mel m is
    ``w[ptr[m]:ptr[m+1]]`` over bins ``lo[m], lo[m]+1, ...`` (its first to
    its last nonzero; an empty filter has no bins). Returns (lo, ptr, w)."""
    lo, ptr, w = [], [0], []
    for col in basis.T:
        nz = np.flatnonzero(col)
        first, last = (nz[0], nz[-1] + 1) if nz.size else (0, 0)
        lo.append(first)
        w.append(col[first:last])
        ptr.append(ptr[-1] + last - first)
    return (np.asarray(lo, np.int32), np.asarray(ptr, np.int32),
            np.concatenate(w).astype(np.float32))


@functools.lru_cache(maxsize=8)
def _device_constants(config: STFTConfig, device: torch.device):
    """Twiddles and the CSR mel basis, uploaded once per (config, device)."""
    arrays = (_twiddles(config.filter_length), *_csr_mel_basis(config.mel_basis()))
    return tuple(torch.as_tensor(a, device=device) for a in arrays)


@functools.lru_cache(maxsize=1)
def _launcher():
    fn = _build.load(SOURCE).logmel_frames
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _frames_to_mel_forward(frames: torch.Tensor, config: STFTConfig) -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain twin on a CPU tensor."""
    if not frames.is_cuda:
        return frames_to_mel_reference(frames, config)
    fft_length = config.filter_length
    if frames.dtype != torch.float32 or frames.ndim != 2:
        raise ValueError(f"expected float32 frames [N, {fft_length}], got "
                         f"{frames.dtype} {tuple(frames.shape)}")
    if frames.shape[1] != fft_length or fft_length not in FFT_LENGTHS:
        raise ValueError(f"frame length {frames.shape[1]} must equal filter_length "
                         f"{fft_length}, one of {FFT_LENGTHS}")
    if not frames.is_contiguous() or frames.data_ptr() % 16:
        raise ValueError("frames must be contiguous and 16-byte aligned")
    n = frames.shape[0]
    out = torch.empty((n, config.n_mel_channels), dtype=torch.float32,
                      device=frames.device)
    if n == 0:
        return out
    twiddle, mel_lo, mel_ptr, mel_w = _device_constants(config, frames.device)
    half_p = config.magnitude_power / 2.0
    power_mode = 1 if half_p == 1.0 else 2 if half_p == 0.5 else 0
    stream = torch.cuda.current_stream(frames.device).cuda_stream
    err = _launcher()(
        frames.data_ptr(), twiddle.data_ptr(), mel_lo.data_ptr(), mel_ptr.data_ptr(),
        mel_w.data_ptr(), out.data_ptr(), n, fft_length, config.n_mel_channels,
        power_mode, half_p, frames.device.index, stream)
    if err != 0:
        raise RuntimeError(f"log-mel kernel launch failed: CUDA error {err}")
    fused_frames_to_mel.launches += 1
    return out


@contextlib.contextmanager
def _f32_matmuls():
    """cuBLAS in full f32 for the block (TF32 off), restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def frames_to_mel_backward(frames: torch.Tensor, grad: torch.Tensor,
                           config: STFTConfig) -> torch.Tensor:
    """Analytic VJP of the log-mel w.r.t. the frames (``_mel_bwd`` of the
    JAX module): recompute re, im, |X|^2 and the mel, then chain log∘clip,
    the mel product, |X|^p and the DFT products back. [N, fft_length]."""
    dr, di, basis = _reference_constants(config, frames.device)
    frames, grad = frames.float(), grad.float()
    with _f32_matmuls():
        re = frames @ dr
        im = frames @ di
        mag_sq = re * re + im * im
        half_p = config.magnitude_power / 2.0
        powered = _power(mag_sq, config.magnitude_power)
        mel = powered @ basis
        # d log(clip(mel, 1e-5)) / d mel: zero below the clip
        g_mel = torch.where(mel >= 1e-5, grad / torch.clamp(mel, min=1e-5),
                            torch.zeros_like(mel))
        g_pow = g_mel @ basis.t()
        # d |X|^p / d |X|^2, zero where |X|^2 = 0 (no inf * 0)
        if half_p == 1.0:
            g_magsq = g_pow
        elif half_p == 0.5:
            g_magsq = torch.where(mag_sq > 0.0, 0.5 * g_pow / torch.clamp(powered, min=1e-30),
                                  torch.zeros_like(g_pow))
        else:
            g_magsq = torch.where(
                mag_sq > 0.0,
                half_p * g_pow * torch.pow(torch.clamp(mag_sq, min=1e-30), half_p - 1.0),
                torch.zeros_like(g_pow))
        return (2.0 * re * g_magsq) @ dr.t() + (2.0 * im * g_magsq) @ di.t()


class _FramesToMel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, frames, config):
        ctx.config = config
        ctx.save_for_backward(frames)
        return _frames_to_mel_forward(frames, config)

    @staticmethod
    def backward(ctx, grad):
        (frames,) = ctx.saved_tensors
        return frames_to_mel_backward(frames, grad, ctx.config), None


def fused_frames_to_mel(frames: torch.Tensor,
                        config: STFTConfig = STFTConfig()) -> torch.Tensor:
    """Windowed frames [N, fft_length] -> log-mel [N, n_mel_channels],
    differentiable (:func:`frames_to_mel_backward`).

    A CUDA tensor goes through the kernel, which takes contiguous float32
    frames and raises on anything else; a CPU tensor goes through
    :func:`frames_to_mel_reference`. ``fused_frames_to_mel.launches`` counts
    the kernel's launches.
    """
    return _FramesToMel.apply(frames, config)


fused_frames_to_mel.launches = 0


def fused_mel_spectrogram(x: torch.Tensor,
                          config: STFTConfig = STFTConfig()) -> torch.Tensor:
    """wav [..., T] -> log-mel [..., n_frames, n_mel] via the fused kernel."""
    frames = windowed_frames(x.float(), config.frame_length, config.frame_step,
                             config.filter_length)
    lead = frames.shape[:-1]
    mel = fused_frames_to_mel(frames.reshape(-1, config.filter_length).contiguous(),
                              config)
    return mel.reshape(lead + (config.n_mel_channels,))
