"""The MSD's folded grouped conv in group-outermost ("gouter") layout.

Counterpart of the gouter subset of ``neuraltexttospeech_tpu/nn/fastconv.py``:
``gouter_tap_dots`` (:70-111), ``fold_gouter``/``unfold_gouter``/
``regroup_gouter`` (:131-184), ``_plan_folded`` (:187-219) and
``Conv._gouter_call`` (:381-466). A grouped, strided SAME conv is rewritten
in space-to-depth form: the length axis is folded by ``Pi`` into channels,
``[B, L, g*ci] -> [g, B, L/Pi, Pi*ci]``, and the conv becomes ``kf`` taps of
a group-batched GEMM over shifted windows of the padded input, which kernel
B2 (``ops/gouter_kernel.py``) computes in one pass. Between two MSD layers of
equal group count the relayout is a free reshape.

The JAX package's ``gmajor``/``bgc`` lowerings and the generator's folded
tail are TPU layout choices for the same math and are not ported.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch.nn import functional as F

from ..ops.gouter_kernel import gouter_tap_dots_kernel
from .precision import promote

__all__ = ["gouter_tap_dots", "fold_gouter", "unfold_gouter", "regroup_gouter",
           "plan_folded", "gouter_weights", "gouter_conv"]


class _TapDots(torch.autograd.Function):
    """``sum_mf xp[..., mf*s + t, :] @ wf[mf]`` with the backward of
    ``fastconv.py:91-108``: dx is the same tap-window sum (the kernel on the
    card) over ``dy`` zero-padded by ``(kf-1)*s`` with the weights flipped
    and transposed (``flip_t``); dw is one einsum over the kf windows. All of
    it runs in the operands' type, f32 or bf16: ``dy`` comes in the output's
    type, and nothing upcasts."""

    @staticmethod
    def forward(ctx, xp, wf, s: int, q: int):
        ctx.s, ctx.q = s, q
        ctx.save_for_backward(xp, wf)
        return gouter_tap_dots_kernel(xp, wf, s, q)

    @staticmethod
    def backward(ctx, dy):
        xp, wf = ctx.saved_tensors
        s, q = ctx.s, ctx.q
        kf, qp = wf.shape[0], xp.shape[2]
        dy = dy.contiguous()
        dxp = dwf = None
        if ctx.needs_input_grad[0]:
            # dxp[u] = sum_mf' dyp[u + mf'*s] @ wf[kf-1-mf']^T, with dyp = dy
            # shifted right by pad and long enough for Qp output rows; the
            # kernel reads wf flipped and transposed in place (flip_t).
            pad = (kf - 1) * s
            dyp = F.pad(dy, (0, 0, pad, qp - q))
            dxp = gouter_tap_dots_kernel(dyp, wf, s, qp, flip_t=True)
        if ctx.needs_input_grad[1]:
            # windows [g, B, kf, X, q] (a view), contracted over (b, t)
            win = xp.unfold(2, q, s)[:, :, :kf]
            dwf = torch.einsum("gbmxt,gbty->mgxy", win, dy)
        return dxp, dwf, None, None


def gouter_tap_dots(xp: torch.Tensor, wf: torch.Tensor, s: int, q: int) -> torch.Tensor:
    """Differentiable tap-window sum: xp [g, B, Qp, X], wf [kf, g, X, Y] ->
    [g, B, q, Y], both f32 or both bf16. Forward and dx run kernel B2 on a
    CUDA tensor and its plain twin on a CPU tensor."""
    if xp.dtype != wf.dtype:
        raise ValueError(f"xp and wf must share a dtype, got {xp.dtype} and {wf.dtype}")
    return _TapDots.apply(xp, wf, s, q)


def fold_gouter(x: torch.Tensor, p: int, g: int) -> torch.Tensor:
    """[B, L, g*ci] -> [g, B, L//p, p*ci], group-outermost folded layout."""
    b, length, c = x.shape
    ci = c // g
    return (x.reshape(b, length // p, p, g, ci).permute(3, 0, 1, 2, 4)
            .reshape(g, b, length // p, p * ci))


def unfold_gouter(x: torch.Tensor, p: int, g: int) -> torch.Tensor:
    """Inverse of :func:`fold_gouter`: [g, B, Q, p*co] -> [B, Q*p, g*co]."""
    _, b, q, pc = x.shape
    co = pc // p
    return (x.reshape(g, b, q, p, co).permute(1, 2, 3, 0, 4)
            .reshape(b, q * p, g * co))


def regroup_gouter(x: torch.Tensor, cur_po: int, cur_g: int, pi: int, g: int) -> torch.Tensor:
    """Relayout to the gouter input of the next folded grouped conv.

    ``x`` is plain ``[B, L, g*ci]`` or the previous layer's gouter output
    ``[cur_g, B, Q, cur_po*co]``; returns ``[g, B, Q', pi*ci]``. At equal
    group count a fold refinement ``cur_po -> pi = A*cur_po`` is a reshape;
    a group refinement ``cur_g -> g = F*cur_g`` is one permute; anything else
    goes through the plain layout."""
    if x.ndim == 3:
        return fold_gouter(x, pi, g)
    gg, b, qc, pc = x.shape
    co = pc // cur_po
    if g == cur_g and pi % cur_po == 0 and qc % (pi // cur_po) == 0:
        a = pi // cur_po
        return x if a == 1 else x.reshape(gg, b, qc // a, a * pc)
    f = g // cur_g if g % cur_g == 0 else 0
    if f > 1 and pi % cur_po == 0 and co % f == 0 and qc % (pi // cur_po) == 0:
        a = pi // cur_po
        ci = co // f
        x = x.reshape(gg, b, qc // a, a, cur_po, f, ci)
        return x.permute(0, 5, 1, 2, 3, 4, 6).reshape(g, b, qc // a, pi * ci)
    return fold_gouter(unfold_gouter(x, cur_po, cur_g), pi, g)


@functools.lru_cache(maxsize=64)
def plan_folded(k: int, st: int, d: int, p: int, po: int):
    """Folded-tap placement of ``fastconv.py::_plan_folded``: returns
    ``(placements, m_min, m_max, s)``; each ``(m, v, r, j)`` puts original
    tap j into folded tap row m at in-position v for out-position r, and s
    is the gcd stride over m. Padding is flax SAME for stride ``st`` (the
    fold guarantees ``L % st == 0``)."""
    if (k - 1) * d + 1 < st:
        raise NotImplementedError(
            f"folded path: kernel span (k-1)*d+1={(k - 1) * d + 1} < stride {st}")
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


@functools.lru_cache(maxsize=64)
def _selector(k: int, st: int, p: int, po: int, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """One-hot [kf, Pi, Po, k]: which original tap lands in each folded slot
    (uploaded once per shape and device)."""
    placements, m_min, m_max, s = plan_folded(k, st, 1, p, po)
    sel = np.zeros(((m_max - m_min) // s + 1, p, po, k), np.float32)
    for m, v, r, j in placements:
        sel[(m - m_min) // s, v, r, j] = 1.0
    return torch.as_tensor(sel, dtype=dtype, device=device)


def gouter_weights(weight: torch.Tensor, groups: int, stride: int, fold: int) -> torch.Tensor:
    """The folded kernel ``wf [kf, g, Pi*ci, Po*co]`` of a grouped conv whose
    ``Conv1d`` weight is ``[g*co, ci, k]``, by the one-hot einsum of
    ``fastconv.py:439-445`` (every slot receives at most one tap)."""
    cout, ci, k = weight.shape
    co, po = cout // groups, fold // stride
    sel = _selector(k, stride, fold, po, weight.dtype, weight.device)
    taps = weight.permute(2, 1, 0).reshape(k, ci, groups, co)  # flax [k, ci, g, co]
    wf = torch.einsum("mvrj,jigo->mgviro", sel, taps)
    return wf.reshape(sel.shape[0], groups, fold * ci, po * co)


def gouter_conv(x: torch.Tensor, weight: torch.Tensor, bias, *, groups: int,
                stride: int = 1, fold: int) -> torch.Tensor:
    """Grouped, undilated SAME conv (flax padding) on gouter input ``[g, B, Q, Pi*ci]``
    -> ``[g, B, Q, Po*co]`` with ``Po = Pi / stride``: pad by
    ``(-m_min, m_max)``, tap-window sum, bias. ``weight`` is the ``Conv1d``
    weight ``[g*co, ci, k]`` and ``bias`` is ``[g*co]`` or None. Input,
    weight and bias are first cast to the compute dtype (``nn/precision.py``),
    as flax's ``promote_dtype`` does, so the kernel sees one dtype."""
    if fold % stride:
        raise NotImplementedError(f"gouter path: fold ({fold}) must be divisible "
                                  f"by stride ({stride})")
    g = groups
    if x.ndim != 4 or x.shape[0] != g:
        raise ValueError(f"gouter input must be [g={g}, B, Q, Pi*ci], got {tuple(x.shape)}")
    x, weight, bias = promote(x, weight, bias)
    k = weight.shape[-1]
    po = fold // stride
    _, m_min, m_max, s = plan_folded(k, stride, 1, fold, po)
    wf = gouter_weights(weight, g, stride, fold)
    q = x.shape[2]
    xp = F.pad(x, (0, 0, -m_min, m_max)).contiguous()
    y = gouter_tap_dots(xp, wf.contiguous(), s, q)
    if bias is not None:
        co = bias.shape[0] // g
        y = y + bias.reshape(g, 1, co).expand(g, po, co).reshape(g, 1, 1, po * co)
    return y
