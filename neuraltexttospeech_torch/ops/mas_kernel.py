"""Monotonic alignment search: the CUDA kernel for Hopper and its plain twin.

Counterpart of ``neuraltexttospeech_tpu/ops/mas.py::maximum_path`` (:36-111),
which is two ``lax.scan``s (a Viterbi forward over mel rows, then a
backtrack) and no Pallas kernel. ``csrc/mas_kernel.cu`` computes it in one
launch, one block per utterance, and writes the whole path itself (its
design and bound are in that file).
:func:`maximum_path_reference` is the same recursion as a PyTorch loop over
the rows: several launches a row on the card, which is why the kernel exists.

:func:`maximum_path` takes the twin only for a CPU tensor; for a CUDA tensor
it launches the kernel or raises. Both give the same f32 add, max and clamp,
so they agree bit for bit. The output carries no gradient: the model treats
the hard alignment as a constant, as JAX ``stop_gradient``s it.

Text lengths must lie in ``[1, T_text]``; an utterance with text length 0
gets an empty path.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build

__all__ = ["maximum_path", "maximum_path_reference", "SOURCE", "MAX_TEXT"]

SOURCE = "mas_kernel.cu"
MAX_TEXT = 1024  # 32 text positions a lane of the chain's warp at most
STAMPS = 5  # the kernel's time stamps: start, forward, backtrack, zeros, end
_NEG = -1e9


@torch.no_grad()
def maximum_path_reference(log_attn: torch.Tensor, in_lens: torch.Tensor,
                           out_lens: torch.Tensor) -> torch.Tensor:
    """Plain twin of the kernel: [B, T_mel, T_text] log attention, [B] text
    and mel lengths -> [B, T_mel, T_text] f32 one-hot path."""
    B, T_mel, T_text = log_attn.shape
    dev = log_attn.device
    neg = torch.tensor(_NEG, dtype=torch.float32, device=dev)
    in_lens, out_lens = in_lens.to(dev).long(), out_lens.to(dev).long()
    j_iota = torch.arange(T_text, device=dev)
    la = torch.where((j_iota[None, :] < in_lens[:, None])[:, None, :], log_attn.float(), neg)

    # forward: row 0 reaches only j == 0; choose[:, i] says the diagonal won
    prev = torch.where(j_iota[None, :] == 0, la[:, 0], neg)
    choose = torch.zeros((B, T_mel, T_text), dtype=torch.bool, device=dev)
    neg_col = neg.expand(B, 1)
    for i in range(1, T_mel):
        shifted = torch.cat([neg_col, prev[:, :-1]], dim=1)
        choose[:, i] = shifted >= prev
        prev = torch.maximum(la[:, i] + torch.maximum(shifted, prev), neg)

    # backtrack from j = in_len - 1; rows at or past out_len stay zero
    path = torch.zeros((B, T_mel, T_text), dtype=torch.float32, device=dev)
    j = in_lens - 1
    b_idx = torch.arange(B, device=dev)
    for i in range(T_mel - 1, -1, -1):
        active = (i < out_lens) & (j >= 0) & (j < T_text)
        path[:, i] = ((j_iota[None, :] == j[:, None]) & active[:, None]).float()
        if i > 0:
            diag = choose[b_idx, i, j.clamp(0, T_text - 1)].long()
            j = torch.where(active, torch.clamp_min(j - diag, 0), j)
    return path


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.load(SOURCE)
    lib.mas_maximum_path.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.mas_maximum_path.restype = ctypes.c_int
    lib.mas_scratch_words.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.mas_scratch_words.restype = ctypes.c_longlong
    return lib


def _lengths(lens: torch.Tensor, batch: int, device) -> torch.Tensor:
    if lens.shape != (batch,):
        raise ValueError(f"expected lengths of shape ({batch},), got {tuple(lens.shape)}")
    return lens.to(device=device, dtype=torch.int32).contiguous()


def maximum_path(log_attn: torch.Tensor, in_lens: torch.Tensor,
                 out_lens: torch.Tensor, stamps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched width-1 MAS: [B, T_mel, T_text] -> f32 hard alignment, one
    one-hot row per mel frame below ``out_lens``.

    A CUDA tensor goes through the kernel (float32, T_text <= 1024; it raises
    on anything else), which writes every element of the path; a CPU tensor
    goes through :func:`maximum_path_reference`. ``maximum_path.launches``
    counts the kernel's launches. ``stamps``, a CUDA int64 ``[B, STAMPS, 2]``,
    asks the kernel for its phase times (``clock64`` and ``%globaltimer``
    at its start and after the forward, the backtrack, the zeros and the
    ones); by default it records none.
    """
    if not log_attn.is_cuda:
        return maximum_path_reference(log_attn, in_lens, out_lens)
    if log_attn.dtype != torch.float32 or log_attn.ndim != 3:
        raise ValueError(f"expected float32 [B, T_mel, T_text], got {log_attn.dtype} "
                         f"{tuple(log_attn.shape)}")
    B, T_mel, T_text = log_attn.shape
    if not 0 < T_text <= MAX_TEXT:
        raise ValueError(f"T_text = {T_text}: the MAS kernel takes 1..{MAX_TEXT} text positions")
    dev = log_attn.device
    if stamps is not None and (stamps.shape != (B, STAMPS, 2) or stamps.dtype != torch.int64
                               or stamps.device != dev or not stamps.is_contiguous()):
        raise ValueError(f"stamps must be a contiguous int64 [{B}, {STAMPS}, 2] on {dev}")
    log_attn = log_attn.detach().contiguous()
    in_lens, out_lens = _lengths(in_lens, B, dev), _lengths(out_lens, B, dev)
    path = torch.empty((B, T_mel, T_text), dtype=torch.float32, device=dev)
    if B == 0 or T_mel == 0:
        return path
    lib = _lib()
    words = lib.mas_scratch_words(T_mel, T_text)
    scratch = torch.empty(B * words, dtype=torch.int32, device=dev) if words else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.mas_maximum_path(log_attn.data_ptr(), in_lens.data_ptr(), out_lens.data_ptr(),
                               path.data_ptr(), None if scratch is None else scratch.data_ptr(),
                               None if stamps is None else stamps.data_ptr(), B, T_mel, T_text,
                               dev.index, stream)
    if err != 0:
        raise RuntimeError(f"MAS kernel launch failed: CUDA error {err}")
    maximum_path.launches += 1
    return path


maximum_path.launches = 0
