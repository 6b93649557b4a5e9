"""Frozen copies of the kernels' roofline counts of ``chip_smoke.py``
(``logmel_bound_ms``, ``msd_tap_shapes``, ``tap_dots_bound_ms``,
``mas_bound_ms``), with the MSD's layer and fold plans they read
(``models/hifigan.py::DiscriminatorS.layer_plan``/``_folded_schedule``,
``nn/fastconv.py::plan_folded``) copied beside them, so that the yardstick
reads nothing of the program. Peaks: NVIDIA's H100 SXM data sheet (dense):
989 TFLOP/s bf16, 495 TFLOP/s TF32, 67 TFLOP/s f32 off the tensor cores,
3.35 TB/s HBM."""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..reference.nets import mel_matrix

BF16_PEAK = 989e12
HBM_BYTES_S = 3.35e12

__all__ = ["MelConfig", "logmel_bound_ms", "msd_tap_shapes", "tap_dots_bound_ms",
           "mas_bound_ms", "BF16_PEAK"]


@dataclasses.dataclass(frozen=True)
class MelConfig:
    """The log-mel's settings, as ``audio/stft.py::STFTConfig`` names them."""

    filter_length: int = 1024
    n_mel_channels: int = 80
    sampling_rate: int = 22050
    mel_fmin: float = 0.0
    mel_fmax: float = 8000.0

    def mel_basis(self) -> np.ndarray:
        return mel_matrix(self.n_mel_channels, self.filter_length, self.sampling_rate,
                          self.mel_fmin, self.mel_fmax)


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


# (channels, kernel, stride, groups) of a scale discriminator's convs
MSD_SPECS = ((128, 15, 1, 1), (128, 41, 2, 4), (256, 41, 2, 16), (512, 41, 4, 16),
             (1024, 41, 4, 16), (1024, 41, 1, 16), (1024, 5, 1, 1))


def _folded_schedule(specs):
    sched = [None] * len(specs)
    nxt_pi = None
    for i in reversed(range(len(specs))):
        ch, k, s, g = specs[i]
        if g == 1:
            nxt_pi = None
            continue
        co_g = ch // g

        def inflation(po):
            pi = s * po
            pl = (k - 1 + 1 - s) // 2
            ms = [(s * r + j - pl) // pi for r in range(po) for j in range(k)]
            return (max(ms) - min(ms) + 1) * pi / k

        po = max(1, 128 // co_g)
        if nxt_pi is not None and 128 <= nxt_pi * co_g <= 512 and inflation(nxt_pi) <= 2.6:
            po = nxt_pi
        elif inflation(po) > 2.6:
            sched[i] = None
            nxt_pi = None
            continue
        sched[i] = (s * po, po)
        nxt_pi = s * po
        if i > 0 and specs[i - 1][3] != g:
            nxt_pi = None
    return sched


def _layer_plan(length):
    plan = []
    for (ch, k, s, g), use in zip(MSD_SPECS, _folded_schedule(MSD_SPECS)):
        if use and (length % use[0] != 0 or use[0] == 1):
            use = None
        plan.append(((ch, k, s, g), use, length))
        length = -(-length // s)
    return plan


def _plan_folded(k, st, d, p, po):
    pl = ((k - 1) * d + 1 - st) // 2
    placements = []
    for r in range(po):
        for j in range(k):
            val = st * r + j * d - pl
            m = val // p
            placements.append((m, val - m * p, r, j))
    m_min = min(pm[0] for pm in placements)
    m_max = max(pm[0] for pm in placements)
    s = 0
    for m, _, _, _ in placements:
        s = math.gcd(s, m - m_min)
    return tuple(placements), m_min, m_max, max(s, 1)


def msd_tap_shapes(batch, length):
    """Every B2 call of one MSD pass over ``batch`` wavs of ``length``
    samples, as ``(scale, layer, forward (g, B, Qp, X, Y, kf, s, q), dx
    shape)``, from the model's own layer plan and fold plan."""
    shapes = []
    for scale in range(3):
        cin = 1
        for layer, ((ch, k, st, g), use, n) in enumerate(_layer_plan(length)):
            if use:
                pi, po = use
                _, m_min, m_max, s = _plan_folded(k, st, 1, pi, po)
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
