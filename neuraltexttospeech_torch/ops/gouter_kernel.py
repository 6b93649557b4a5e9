"""Tap-window grouped GEMM: the CUDA kernel for Hopper and its plain twin.

Counterpart of ``neuraltexttospeech_tpu/ops/gouter_kernel.py`` (the Pallas
kernel ``gouter_tap_dots_pallas``, ``pallas_call`` at :114). The MSD's folded,
grouped, strided conv (``nn/fastconv.py``) computes

    y[g, b, t, :] = sum_mf xp[g, b, mf*s + t, :] @ wf[mf, g, :, :]

for ``t < q``, with xp ``[g, B, Qp, X]`` padded and wf ``[kf, g, X, Y]``, both
float32 or both bfloat16; every product is summed in f32 and y, in the
operands' type, is rounded once, as the Pallas body (:105-112) does. With
``flip_t`` the weights enter flipped over the taps and transposed
(``wf[kf-1-mf, g].T``), the form of the backward's dx.
``csrc/gouter_kernel.cu`` computes it on the tensor cores, f32-accurate by
3xTF32 for f32 operands and by one bf16 product per step for bf16 ones (its
design and bound are in that file): a prologue kernel writes the weights
K-major and swizzled, f32 split into TF32 hi and lo parts
(:func:`pack_weights`; twin :func:`pack_weights_reference`), then the main
kernel of the operands' form runs at the plan :func:`plan_tiles` (f32) or
:func:`plan_window` (bf16) picks. The bf16 kernel loads each tile's A
window once per unit of K and runs all the unit's taps against it;
:func:`window_segments` and :func:`window_row` are its index arithmetic.
:func:`gouter_tap_dots_reference` is the per-tap ``torch.matmul`` loop of
``fastconv.py:62-67`` in f32; :func:`gouter_tap_dots_kernel` takes it only
for a CPU tensor. For a CUDA tensor it launches the kernels or raises: they
take every shape the v1 MSD produces (X and Y of 128, 256 or 512, g of 4 or
16, kf up to 21, any q), and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["gouter_tap_dots_kernel", "gouter_tap_dots_reference", "pack_weights",
           "pack_weights_reference", "plan_tiles", "plan_window", "window_segments",
           "window_row", "window_rows", "k_block", "tf32_round", "SOURCE"]

SOURCE = "gouter_kernel.cu"
_WIDTHS = (128, 256, 512)  # X and Y the kernel takes
_GROUPS = (4, 16)
_MAX_TAPS = 21
_DTYPES = (torch.float32, torch.bfloat16)
_TILES = ((2, 128), (1, 64))  # (warpgroups of 64 rows, columns): 128x128, then 64x64
# the bf16 kernel's tiles: 64-row tiles by 128 columns, 256 rows (two
# warpgroups of two 64-row tiles), 128 and 64
_WIN_TILES = (4, 2, 1)
_WIN_PITCH = 144   # bytes per window row in shared memory
_B_STAGES = 6      # the bf16 kernel's B ring, at least,
_MAX_B_STAGES = 12  # and at most, as room is left beside
_WIN_BUFS = 3      # its window buffers
_MAX_SMEM = 232448


def k_block(dtype: torch.dtype) -> int:
    """K per pipeline stage, one 128-byte row: 32 f32 or 64 bf16."""
    return 128 // dtype.itemsize


def gouter_tap_dots_reference(xp: torch.Tensor, wf: torch.Tensor, s: int, q: int,
                              flip_t: bool = False) -> torch.Tensor:
    """Plain twin: ``sum_mf xp[:, :, mf*s : mf*s + q] @ w[mf]`` as one
    group-batched f32 ``torch.matmul`` per tap, with ``w = wf`` or, for
    ``flip_t``, ``flip(wf, taps).transpose(-1, -2)``; the sum is rounded
    once to ``xp.dtype`` (bf16 products are exact in f32). [g, B, q, Y]."""
    if flip_t:
        wf = torch.flip(wf, (0,)).transpose(-1, -2)
    y = None
    for mf in range(wf.shape[0]):
        t = torch.matmul(xp[:, :, mf * s: mf * s + q].float(), wf[mf].float().unsqueeze(1))
        y = t if y is None else y + t
    return y.to(xp.dtype)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, low 13 bits cleared: what ``cvt.rna.tf32.f32`` gives."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _swizzle_rows(w: torch.Tensor) -> torch.Tensor:
    """[..., n, k] of 128-byte rows (k = 32 f32 or 64 bf16) -> the same with
    16-byte chunk c of row n at c ^ (n % 8), the 128-byte swizzle wgmma reads
    (its own inverse)."""
    n = w.shape[-2]
    perm = torch.arange(8)[None, :] ^ (torch.arange(n) % 8)[:, None]  # [n, 8]
    chunks = w.reshape(*w.shape[:-1], 8, w.shape[-1] // 8)
    index = perm.to(w.device)[..., None].expand(chunks.shape)
    return torch.gather(chunks, -2, index).reshape(w.shape)


def pack_weights_reference(wf: torch.Tensor, flip_t: bool = False) -> torch.Tensor:
    """Plain twin of the prologue kernel: the B operand ``b[mf, g, n, k]``
    (``wf[mf, g, k, n]``, or ``wf[kf-1-mf, g, n, k]`` for ``flip_t``) laid out
    ``[parts, kf, g, K/kb, N, kb]`` with swizzled rows: f32 split into
    ``hi = tf32(b)`` and ``lo = tf32(b - hi)`` (parts 2, kb 32), bf16 as it
    is (parts 1, kb 64)."""
    b = torch.flip(wf, (0,)) if flip_t else wf.transpose(-1, -2)
    if wf.dtype == torch.bfloat16:
        w = b[None]
    else:
        b = b.float()
        hi = tf32_round(b)
        w = torch.stack([hi, tf32_round(b - hi)])  # [2, kf, g, n, k]
    parts, kf, g, n, k = w.shape
    kb = k_block(wf.dtype)
    w = w.reshape(parts, kf, g, n, k // kb, kb).transpose(3, 4)
    return _swizzle_rows(w.contiguous())


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.load(SOURCE)
    lib.gouter_pack_weights.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
                                        + [ctypes.c_void_p])
    lib.gouter_tap_dots.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    lib.gouter_window_taps_bf16.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 12
                                            + [ctypes.c_void_p])
    for fn in (lib.gouter_pack_weights, lib.gouter_tap_dots, lib.gouter_window_taps_bf16):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=8)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def plan_tiles(g: int, m: int, n: int, n_kblocks: int, sms: int = 132):
    """The main kernel's launch for a call of M = B*q rows, N columns and
    ``n_kblocks`` K blocks (of :func:`k_block`) per group: ``(warpgroups, tile columns,
    splits)``. The first tile of :data:`_TILES` that gives at least one block
    per SM; else 64x64 tiles with K split over enough blocks, each split a
    contiguous run of K blocks (no split is empty)."""
    for nwg, bn in _TILES:
        blocks = -(-m // (64 * nwg)) * (n // bn) * g
        if blocks >= sms:
            return nwg, bn, 1
    splits = min(n_kblocks, -(-sms // blocks))
    per = -(-n_kblocks // splits)
    return nwg, bn, -(-n_kblocks // per)


def window_segments(m0: int, m_end: int, q: int, qp: int, mf0: int, taps: int, s: int):
    """The loads of one window of the bf16 kernel: output rows ``[m0,
    m_end)`` of the ``B*q``, taps ``mf0 .. mf0 + taps - 1``. One entry per
    batch segment the tile touches, ``(xp_row, window_row, rows)``: ``rows``
    rows of ``xp[g]`` viewed ``[B*Qp, X]`` from ``xp_row`` go to the window
    from ``window_row``, one segment after another."""
    span = (taps - 1) * s
    b_first, b_last = m0 // q, (m_end - 1) // q
    segments, w = [], 0
    for b in range(b_first, b_last + 1):
        t_lo = m0 - b * q if b == b_first else 0
        t_hi = m_end - 1 - b * q if b == b_last else q - 1
        rows = t_hi - t_lo + 1 + span
        segments.append((b * qp + t_lo + mf0 * s, w, rows))
        w += rows
    return segments


def window_row(r: int, m0: int, q: int, span: int) -> int:
    """The window row that output row ``r`` of the tile at ``m0`` reads at
    the unit's first tap (tap ``mf0 + j`` reads ``j*s`` rows further);
    ``span = (taps - 1)*s``."""
    return (r - m0) + (r // q - m0 // q) * span


@functools.lru_cache(maxsize=None)
def window_rows(m: int, q: int, bm: int, span: int) -> int:
    """The most window rows any tile of ``bm`` of the ``m = B*q`` rows needs
    (cached: a training step asks for the same shapes every step)."""
    most = 0
    for m0 in range(0, m, bm):
        m_end = min(m0 + bm, m)
        most = max(most, m_end - m0 + ((m_end - 1) // q - m0 // q + 1) * span)
    return most


def _window_capacity() -> int:
    """Window rows that fit one of the kernel's window buffers beside its
    smallest B ring (of 128-column tiles)."""
    barriers = (2 * _MAX_B_STAGES + 2 * _WIN_BUFS) * 8
    return (_MAX_SMEM - 1024 - barriers - _B_STAGES * 128 * 128) // (_WIN_BUFS * _WIN_PITCH)


@functools.lru_cache(maxsize=None)
def plan_window(g: int, m: int, n: int, q: int, kf: int, s: int, kc: int, sms: int = 132):
    """The bf16 kernel's launch for a call of M = B*q rows, N columns, kf
    taps of stride s over X = kc: ``(64-row tiles, taps per unit, splits)``.
    The tallest of 256, 128 and 64 rows (by 128 columns) that gives at least
    half as many blocks as SMs and whose window holds all kf taps; where
    even 64 rows give fewer blocks, the units of K (64 values of X by a
    group of taps) are split over blocks until they do. (Measured on an
    H100 at the 30 v1 MSD shapes, every tile with splits of 1 and 2, and
    64-column tiles too: tall tiles read each weight tile for more rows, and
    a card a quarter full could not fill itself.)"""
    def blocks(tiles):
        return -(-m // (64 * tiles)) * (n // 128) * g

    cap = _window_capacity()
    taps = kf
    for tiles in _WIN_TILES:
        if 2 * blocks(tiles) >= sms and window_rows(m, q, 64 * tiles, (kf - 1) * s) <= cap:
            break
    else:
        tiles = 1
        while taps > 1 and window_rows(m, q, 64, (taps - 1) * s) > cap:
            taps -= 1
    n_units = kc // 64 * -(-kf // taps)
    splits = min(n_units, -(-sms // (2 * blocks(tiles))))
    per = -(-n_units // splits)
    return tiles, taps, -(-n_units // per)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def pack_weights(wf: torch.Tensor, flip_t: bool = False) -> torch.Tensor:
    """The prologue: :func:`pack_weights_reference` by the kernel on a CUDA
    tensor (contiguous float32 or bfloat16 ``wf``), by the twin on a CPU
    tensor."""
    if not wf.is_cuda:
        return pack_weights_reference(wf, flip_t)
    kf, g, x_dim, y_dim = wf.shape
    n, kc = (x_dim, y_dim) if flip_t else (y_dim, x_dim)
    bf16 = wf.dtype == torch.bfloat16
    kb = k_block(wf.dtype)
    wk = torch.empty((1 if bf16 else 2, kf, g, kc // kb, n, kb), dtype=wf.dtype,
                     device=wf.device)
    err = _lib().gouter_pack_weights(wf.data_ptr(), wk.data_ptr(), kf, g, kc, n, int(flip_t),
                                     int(bf16), wf.device.index, _stream(wf))
    if err != 0:
        raise RuntimeError(f"weight-pack kernel launch failed: CUDA error {err}")
    return wk


def _check(xp: torch.Tensor, wf: torch.Tensor, s: int, q: int, flip_t: bool = False):
    if xp.dtype not in _DTYPES or wf.dtype != xp.dtype:
        raise ValueError(f"expected float32 or bfloat16, the same for both, got {xp.dtype} "
                         f"and {wf.dtype}")
    if xp.ndim != 4 or wf.ndim != 4 or wf.device != xp.device:
        raise ValueError(f"expected xp [g, B, Qp, X] and wf [kf, g, X, Y] on one "
                         f"device, got {tuple(xp.shape)} and {tuple(wf.shape)}")
    g, _, qp, x_dim = xp.shape
    kf, g2, x2, y_dim = wf.shape
    if flip_t:
        x2, y_dim = y_dim, x2
    if g2 != g or x2 != x_dim:
        raise ValueError(f"xp {tuple(xp.shape)} and wf {tuple(wf.shape)} disagree")
    if x_dim not in _WIDTHS or y_dim not in _WIDTHS or g not in _GROUPS:
        raise ValueError(f"the kernel takes X, Y in {_WIDTHS} and g in {_GROUPS}; "
                         f"got X={x_dim}, Y={y_dim}, g={g}")
    if not 1 <= kf <= _MAX_TAPS or s < 1 or q < 1 or qp < q + (kf - 1) * s:
        raise ValueError(f"bad taps: kf={kf} (at most {_MAX_TAPS}), s={s}, q={q}, "
                         f"Qp={qp} < q + (kf - 1)*s")
    for name, t in (("xp", xp), ("wf", wf)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def gouter_tap_dots_kernel(xp: torch.Tensor, wf: torch.Tensor, s: int, q: int,
                           flip_t: bool = False) -> torch.Tensor:
    """``y[g, b, t, :] = sum_mf xp[g, b, mf*s + t, :] @ w[mf, g]`` for
    ``t < q``, ``w = wf`` or (``flip_t``) ``flip(wf, taps).transpose(-1, -2)``:
    [g, B, q, N].

    y is in the operands' type, float32 or bfloat16. A CUDA tensor goes
    through the kernels, which raise on a type, shape or layout they do not
    take; a CPU tensor goes through :func:`gouter_tap_dots_reference`.
    ``gouter_tap_dots_kernel.launches`` counts the calls that launched the
    kernels, ``.bf16_launches`` those of them on bfloat16 operands."""
    if not xp.is_cuda:
        return gouter_tap_dots_reference(xp, wf, s, q, flip_t)
    _check(xp, wf, s, q, flip_t)
    g, batch, qp, kc = xp.shape
    kf = wf.shape[0]
    n = wf.shape[2] if flip_t else wf.shape[3]
    bf16 = xp.dtype == torch.bfloat16
    y = torch.empty((g, batch, q, n), dtype=xp.dtype, device=xp.device)
    if batch == 0:
        return y
    wk = pack_weights(wf, flip_t)
    m, sms = batch * q, _sm_count(xp.device)
    if bf16:
        tiles, taps, splits = plan_window(g, m, n, q, kf, s, kc, sms)
    else:
        nwg, bn, splits = plan_tiles(g, m, n, kf * kc // k_block(xp.dtype), sms)
    partial = (torch.empty((splits, g, m, n), dtype=torch.float32, device=xp.device)
               if splits > 1 else None)
    args = (xp.data_ptr(), wk.data_ptr(), None if partial is None else partial.data_ptr(),
            y.data_ptr(), g, batch, qp, kc, n, kf, s, q)
    if bf16:
        err = _lib().gouter_window_taps_bf16(*args, tiles, taps, splits, xp.device.index,
                                             _stream(xp))
    else:
        err = _lib().gouter_tap_dots(*args, nwg, bn, splits, xp.device.index, _stream(xp))
    if err != 0:
        raise RuntimeError(f"tap-window kernel launch failed: CUDA error {err}")
    gouter_tap_dots_kernel.launches += 1
    gouter_tap_dots_kernel.bf16_launches += bf16
    return y


gouter_tap_dots_kernel.launches = 0
gouter_tap_dots_kernel.bf16_launches = 0
