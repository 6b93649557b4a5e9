"""YIN and probabilistic-YIN pitch (f0) estimation in PyTorch, on the host.

Counterpart of ``neuraltexttospeech_tpu/data/pitch.py``. Pitch is dataset
preparation: JAX pins it to the host CPU (``data/pitch.py:350-355``) so it
never competes with the accelerator, and the port does the same —
:func:`estimate_pitch` computes on the CPU whatever device the run trains
on (the mels of the same items go through kernel B1 on the card).

The YIN difference function is computed for all frames and lags at once,
with an FFT autocorrelation and a cumulative-energy identity
(de Cheveigné & Kawahara 2002, as in ``librosa.yin``):

  d(τ)  = E[0] + E[τ] − 2·r(τ)      (energies by cumsum, r by rFFT)
  d'(τ) = d(τ) · τ / Σ_{1..τ} d     (cumulative-mean normalization)

:func:`yin_pitch` takes the first trough of d' below a threshold (else the
in-band minimum), refined by parabolic interpolation; unvoiced frames are
0. :func:`pyin_pitch` is librosa's ``pyin`` layer on top: trough
probabilities from a Beta(2, 18) threshold prior with boltzmann weighting,
a 2·n_bins-state pitch/voicing HMM and its Viterbi decode (:272-288 in JAX,
a loop over frames here).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from scipy.special import betainc
from torch.nn import functional as F

__all__ = ["yin_pitch", "pyin_pitch", "estimate_pitch", "normalize_pitch"]

# librosa.note_to_hz('C2'), ('C7') — the reference's pyin band.
FMIN_C2 = 65.40639132514966
FMAX_C7 = 2093.004522404789


def _cmnd_frames(audio, sr, frame_length, hop_length, win_length, fmin, fmax, center):
    """Framed cumulative-mean-normalized YIN difference.

    Returns (cmnd [N, tau_max+1], is_trough mask, tau_min, tau_max)."""
    if win_length is None:
        win_length = frame_length // 2
    tau_min = max(1, int(sr / fmax))
    tau_max = min(int(sr / fmin) + 1, frame_length - win_length - 1)

    x = torch.as_tensor(np.asarray(audio, np.float32))
    if center:
        x = F.pad(x, (frame_length // 2, frame_length // 2))
    total = x.shape[0]
    n_avail = max(1, 1 + (total - frame_length) // hop_length)
    idx = (torch.arange(n_avail)[:, None] * hop_length
           + torch.arange(frame_length)[None, :]).clamp_max(total - 1)
    frames = x[idx]  # [N, frame_length]

    # autocorrelation r(τ) = Σ_{j<W} x[j]·x[j+τ] for all τ, by rFFT
    n_fft = int(2 ** np.ceil(np.log2(2 * frame_length)))
    windowed = torch.where(torch.arange(frame_length)[None, :] < win_length, frames,
                           torch.zeros(()))
    f_full = torch.fft.rfft(frames, n=n_fft, dim=-1)
    f_win = torch.fft.rfft(windowed, n=n_fft, dim=-1)
    acf = torch.fft.irfft(f_full * torch.conj(f_win), n=n_fft, dim=-1)[:, :tau_max + 1]

    # energies E[τ] = Σ_{j<W} x[j+τ]² by cumsum of squares
    sq_cumsum = F.pad(torch.cumsum(torch.square(frames), dim=-1), (1, 0))
    tau_idx = torch.arange(tau_max + 1)
    energy_tau = sq_cumsum[:, tau_idx + win_length] - sq_cumsum[:, tau_idx]
    diff = torch.clamp_min(energy_tau[:, :1] + energy_tau - 2.0 * acf, 0.0)

    # d'(τ), with d'(0) = 1
    tau_f = tau_idx.float()
    cum = torch.cumsum(diff[:, 1:], dim=-1)
    cmnd = torch.cat([torch.ones_like(diff[:, :1]),
                      diff[:, 1:] * tau_f[None, 1:] / torch.clamp_min(cum, 1e-12)], dim=-1)

    # troughs within [tau_min, tau_max)
    in_band = (tau_idx >= tau_min) & (tau_idx < tau_max)
    left = F.pad(cmnd[:, :-1], (1, 0), value=float("inf"))
    right = F.pad(cmnd[:, 1:], (0, 1), value=float("inf"))
    is_trough = (cmnd <= left) & (cmnd < right) & in_band[None, :]
    return cmnd, is_trough, tau_min, tau_max


def _parabolic_period(cmnd, tau, tau_max):
    """Refine integer lags ``tau`` [N, K] by parabolic interpolation on d'."""
    d0 = torch.gather(cmnd, -1, torch.clamp_min(tau - 1, 0))
    d1 = torch.gather(cmnd, -1, tau)
    d2 = torch.gather(cmnd, -1, torch.clamp_max(tau + 1, tau_max))
    denom = 2.0 * (2.0 * d1 - d0 - d2)
    shift = torch.where(torch.abs(denom) > 1e-12, (d2 - d0) / denom, torch.zeros(()))
    return tau.float() + torch.clamp(shift, -0.5, 0.5)


def _fit_frames(f0: torch.Tensor, n_frames: Optional[int]) -> torch.Tensor:
    if n_frames is None:
        return f0
    if n_frames <= f0.shape[0]:
        return f0[:n_frames]
    return F.pad(f0, (0, n_frames - f0.shape[0]))


@torch.no_grad()
def yin_pitch(audio, *, sr: int = 22050, frame_length: int = 1024, hop_length: int = 256,
              win_length: Optional[int] = None, fmin: float = FMIN_C2,
              fmax: float = FMAX_C7, trough_threshold: float = 0.1,
              n_frames: Optional[int] = None, center: bool = True) -> torch.Tensor:
    """Per-frame f0 in Hz (0.0 = unvoiced) for a mono waveform [T].

    ``center=True`` pads by frame_length//2 (librosa); ``n_frames`` cuts or
    zero-pads the output to that many frames."""
    cmnd, is_trough, tau_min, tau_max = _cmnd_frames(
        audio, sr, frame_length, hop_length, win_length, fmin, fmax, center)
    tau_idx = torch.arange(tau_max + 1)
    tau_f = tau_idx.float()
    in_band = (tau_idx >= tau_min) & (tau_idx < tau_max)
    below = is_trough & (cmnd < trough_threshold)
    big = torch.tensor(1e9)
    first_tau = torch.argmin(torch.where(below, tau_f[None, :], big), dim=-1)
    any_below = below.any(dim=-1)
    fallback = torch.argmin(torch.where(in_band[None, :], cmnd, big), dim=-1)
    tau_star = torch.where(any_below, first_tau, fallback)
    period = _parabolic_period(cmnd, tau_star[:, None], tau_max)[:, 0]
    f0 = torch.where(any_below, sr / torch.clamp_min(period, 1.0), torch.zeros(()))
    return _fit_frames(f0, n_frames)


@torch.no_grad()
def pyin_pitch(audio, *, sr: int = 22050, frame_length: int = 1024, hop_length: int = 256,
               win_length: Optional[int] = None, fmin: float = FMIN_C2,
               fmax: float = FMAX_C7, n_frames: Optional[int] = None, center: bool = True,
               n_candidates: int = 6, bins_per_semitone: int = 10, n_thresholds: int = 100,
               beta_a: float = 2.0, beta_b: float = 18.0, boltzmann: float = 2.0,
               no_trough_prob: float = 0.01, switch_prob: float = 0.01,
               max_transition_rate: float = 35.92) -> torch.Tensor:
    """Probabilistic YIN (librosa ``pyin``): per-frame f0 in Hz, 0.0 =
    unvoiced. Every CMND trough is an f0 candidate whose probability
    integrates a Beta prior over YIN thresholds with boltzmann weighting of
    trough order; candidates vote into 1/``bins_per_semitone``-semitone bins;
    a voiced/unvoiced pitch-bin HMM is Viterbi-decoded."""
    cmnd, is_trough, tau_min, tau_max = _cmnd_frames(
        audio, sr, frame_length, hop_length, win_length, fmin, fmax, center)
    N, K = cmnd.shape[0], n_candidates

    # K deepest troughs per frame; ties keep the lower lag first (lax.top_k)
    masked = torch.where(is_trough, cmnd, torch.tensor(float("inf")))
    neg_vals, order = torch.sort(-masked, dim=-1, descending=True, stable=True)
    cand_tau = order[:, :K]
    cand_val = -neg_vals[:, :K]
    cand_ok = torch.isfinite(cand_val)
    cand_val = torch.where(cand_ok, cand_val, torch.tensor(1e9))
    period = _parabolic_period(cmnd, cand_tau, tau_max)
    cand_f0 = sr / torch.clamp_min(period, 1.0)

    # trough probabilities: a beta prior over thresholds
    edges = np.linspace(0.0, 1.0, n_thresholds + 1)
    bcdf = betainc(beta_a, beta_b, edges.astype(np.float32).astype(np.float64))
    w = torch.as_tensor((bcdf[1:] - bcdf[:-1]).astype(np.float32))       # [J]
    t_j = torch.as_tensor(edges[1:].astype(np.float32))                  # [J]
    below_t = cand_val[:, :, None] < t_j[None, None, :]                  # [N, K, J]
    # rank[n,i,j] = #{a : tau_a < tau_i and cmnd_a < t_j}
    tau_order = (cand_tau[:, :, None] < cand_tau[:, None, :]).float()  # [N, a, i]
    rank = torch.einsum("nai,naj->nij", tau_order, below_t.float())
    n_below = below_t.sum(dim=1, keepdim=True).float()
    bw = torch.exp(-boltzmann * rank)
    q = float(np.exp(-boltzmann))
    z = torch.where(n_below > 0, (1.0 - q ** n_below) / (1.0 - q), torch.ones(()))
    probs = torch.sum(torch.where(below_t, bw / z, torch.zeros(())) * w[None, None, :], dim=-1)
    none_mass = torch.sum(torch.where(below_t.sum(dim=1) == 0, w[None, :], torch.zeros(())),
                          dim=-1)
    global_min = torch.argmin(cand_val, dim=-1)
    probs = probs + F.one_hot(global_min, K).float() * none_mass[:, None] * no_trough_prob
    probs = torch.where(cand_ok, probs, torch.zeros(()))
    voiced_prob = torch.clamp(probs.sum(dim=-1), 0.0, 1.0)

    # observations over pitch bins
    n_bins = int(np.ceil(12 * bins_per_semitone * np.log2(fmax / fmin))) + 1
    cand_bin = torch.clamp(torch.round(
        12.0 * bins_per_semitone * torch.log2(torch.clamp_min(cand_f0, 1e-6) / fmin)
    ).long(), 0, n_bins - 1)
    obs_v = torch.zeros((N, n_bins)).scatter_add_(1, cand_bin, probs)
    obs_u = ((1.0 - voiced_prob) / n_bins)[:, None] * torch.ones((N, n_bins))
    log_obs = torch.log(torch.clamp_min(torch.cat([obs_v, obs_u], dim=-1), 1e-12))

    # transitions: triangular local moves ⊗ the voicing switch
    max_bins = max(1, int(round(max_transition_rate * 12 * bins_per_semitone
                                * hop_length / sr)))
    d = np.abs(np.arange(n_bins)[:, None] - np.arange(n_bins)[None, :])
    local = np.maximum(0.0, 1.0 - d / (max_bins + 1.0))
    local = local / local.sum(axis=1, keepdims=True)
    sw = np.array([[1.0 - switch_prob, switch_prob], [switch_prob, 1.0 - switch_prob]])
    log_t = torch.as_tensor(np.log(np.maximum(np.kron(sw, local), 1e-12)).astype(np.float32))

    # Viterbi: max-product forward, then the backtrace
    carry = torch.log(torch.full((2 * n_bins,), 1.0 / (2 * n_bins))) + log_obs[0]
    args = []
    for t in range(1, N):
        best, arg = torch.max(carry[:, None] + log_t, dim=0)
        carry = best + log_obs[t]
        args.append(arg)
    states = [int(torch.argmax(carry))]
    for arg in reversed(args):
        states.append(int(arg[states[-1]]))
    states = torch.as_tensor(states[::-1])

    voiced = states < n_bins
    bin_idx = torch.where(voiced, states, states - n_bins)
    dist = torch.abs(cand_bin - bin_idx[:, None])
    pick = torch.argmin(torch.where(cand_ok, dist, torch.tensor(10 ** 6)), dim=-1)
    picked_f0 = torch.gather(cand_f0, -1, pick[:, None])[:, 0]
    picked_bin = torch.gather(cand_bin, -1, pick[:, None])[:, 0]
    center_f0 = fmin * torch.pow(2.0, bin_idx.float() / (12.0 * bins_per_semitone))
    f0 = torch.where(torch.abs(picked_bin - bin_idx) <= 1, picked_f0, center_f0)
    f0 = torch.where(voiced, f0, torch.zeros(()))
    return _fit_frames(f0, n_frames)


def normalize_pitch(pitch: np.ndarray, mean: float, std: float) -> np.ndarray:
    """Mean/std normalize, keeping unvoiced zeros at zero."""
    return np.where(pitch == 0.0, 0.0, (pitch - mean) / std)


# Audio is zero-padded to a multiple of this many samples before pitch
# extraction, as in JAX (there it bounds the compiled shapes; here it keeps
# the frames, and so the Viterbi decode, identical to JAX's).
_PAD_QUANTUM = 32768


def estimate_pitch(audio, mel_len: Optional[int] = None, *, sr: int = 22050,
                   hop_length: int = 256, frame_length: int = 1024,
                   normalize_mean: Optional[float] = None,
                   normalize_std: Optional[float] = None, n_formants: int = 1,
                   method: str = "pyin") -> np.ndarray:
    """Waveform -> [n_formants, n_frames] (optionally normalized) f0 aligned
    with the mel frames, computed on the host CPU. ``method`` is "pyin" (the
    reference's extractor) or "yin"."""
    if n_formants != 1:
        raise NotImplementedError("only 1 formant, like the reference")
    x = np.asarray(audio, np.float32)
    n = len(x)
    padded = int(np.ceil(max(n, 1) / _PAD_QUANTUM)) * _PAD_QUANTUM
    x = np.pad(x, (0, padded - n))
    out_frames = mel_len if mel_len is not None else 1 + n // hop_length
    fn = pyin_pitch if method == "pyin" else yin_pitch
    f0 = fn(x, sr=sr, frame_length=frame_length, hop_length=hop_length).numpy().copy()
    # frames the padding added are unvoiced by fiat
    f0[1 + n // hop_length:] = 0.0
    if out_frames <= len(f0):
        f0 = f0[:out_frames]
    else:
        f0 = np.pad(f0, (0, out_frames - len(f0)))
    if normalize_mean is not None:
        if normalize_std is None:
            raise ValueError("normalize_mean needs normalize_std")
        f0 = normalize_pitch(f0, normalize_mean, normalize_std).astype(np.float32)
    return f0[None, :]
