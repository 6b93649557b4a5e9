"""Tap-window grouped GEMM: the CUDA kernel for Hopper and its plain twin.

Counterpart of ``neuraltexttospeech_tpu/ops/gouter_kernel.py`` (the Pallas
kernel ``gouter_tap_dots_pallas``, ``pallas_call`` at :114). The MSD's folded,
grouped, strided conv (``nn/fastconv.py``) computes

    y[g, b, t, :] = sum_mf xp[g, b, mf*s + t, :] @ wf[mf, g, :, :]

for ``t < q``, with xp ``[g, B, Qp, X]`` padded and wf ``[kf, g, X, Y]``.
``csrc/gouter_kernel.cu`` computes it in one pass on the card (its design and
bound are in that file). :func:`gouter_tap_dots_reference` is the per-tap
``torch.matmul`` loop of ``fastconv.py:62-67``; :func:`gouter_tap_dots_kernel`
takes it only for a CPU tensor. For a CUDA tensor it launches the kernel or
raises: the kernel takes every shape the v1 MSD produces (X and Y of 128, 256
or 512, g of 4 or 16, kf up to 21, any q), and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["gouter_tap_dots_kernel", "gouter_tap_dots_reference", "SOURCE"]

SOURCE = "gouter_kernel.cu"
_WIDTHS = (128, 256, 512)  # X and Y the kernel takes
_GROUPS = (4, 16)
_MAX_TAPS = 21


def gouter_tap_dots_reference(xp: torch.Tensor, wf: torch.Tensor, s: int,
                              q: int) -> torch.Tensor:
    """Plain twin: ``sum_mf xp[:, :, mf*s : mf*s + q] @ wf[mf]`` as one
    group-batched ``torch.matmul`` per tap. [g, B, q, Y]."""
    y = None
    for mf in range(wf.shape[0]):
        t = torch.matmul(xp[:, :, mf * s: mf * s + q], wf[mf].unsqueeze(1))
        y = t if y is None else y + t
    return y


@functools.lru_cache(maxsize=1)
def _launcher():
    fn = _build.load(SOURCE).gouter_tap_dots
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(xp: torch.Tensor, wf: torch.Tensor, s: int, q: int):
    if xp.dtype != torch.float32 or wf.dtype != torch.float32:
        raise ValueError(f"expected float32, got {xp.dtype} and {wf.dtype}")
    if xp.ndim != 4 or wf.ndim != 4 or wf.device != xp.device:
        raise ValueError(f"expected xp [g, B, Qp, X] and wf [kf, g, X, Y] on one "
                         f"device, got {tuple(xp.shape)} and {tuple(wf.shape)}")
    g, _, qp, x_dim = xp.shape
    kf, g2, x2, y_dim = wf.shape
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


def gouter_tap_dots_kernel(xp: torch.Tensor, wf: torch.Tensor, s: int,
                           q: int) -> torch.Tensor:
    """``y[g, b, t, :] = sum_mf xp[g, b, mf*s + t, :] @ wf[mf, g]`` for
    ``t < q``: [g, B, q, Y].

    A CUDA tensor goes through the kernel, which raises on a shape or layout
    it does not take; a CPU tensor goes through
    :func:`gouter_tap_dots_reference`. ``gouter_tap_dots_kernel.launches``
    counts the kernel's launches."""
    if not xp.is_cuda:
        return gouter_tap_dots_reference(xp, wf, s, q)
    _check(xp, wf, s, q)
    g, batch, qp, x_dim = xp.shape
    kf, _, _, y_dim = wf.shape
    y = torch.empty((g, batch, q, y_dim), dtype=torch.float32, device=xp.device)
    if batch == 0:
        return y
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    err = _launcher()(xp.data_ptr(), wf.data_ptr(), y.data_ptr(), g, batch, qp,
                      x_dim, y_dim, kf, s, q, xp.device.index, stream)
    if err != 0:
        raise RuntimeError(f"tap-window kernel launch failed: CUDA error {err}")
    gouter_tap_dots_kernel.launches += 1
    return y


gouter_tap_dots_kernel.launches = 0
