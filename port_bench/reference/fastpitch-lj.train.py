"""Reference of the ``fastpitch-lj`` configuration's training: FastPitch's
training forward, its losses and their gradients by autograd, and LAMB with
the noam warm-up and gradient accumulation, in plain PyTorch at the
program's padded batch shapes, in the arithmetic of :class:`~.nets.Arith`
(f32 with TF32 off; the control's fp8 operands).

The forward follows NVIDIA DeepLearningExamples' FastPitch (``model.py``,
``alignment.py``, ``attn_loss_function.py``, ``loss_function.py``) on the
leaves of :class:`~.nets.FastPitchRef`: the encoder, the duration and pitch
predictors, the aligner (the key and query convs, squared distances as a
broadcast difference, log-softmax at temperature 0.0005 plus the log of the
beta-binomial prior, made here in float64), MAS (``mas_width1``: float32
sums, the diagonal winning ties), the pitch and energy targets averaged
over each token's frames, the energy predictor after the pitch embedding,
length regulation (a gather along the path), the decoder and the
projection; the masked MSEs, the CTC forward-sum (``F.ctc_loss``, one
utterance at a time over its own frames and ``1 + text`` classes) and the
binarization KL.

Where the port follows the JAX package rather than NVIDIA's code, this file
follows the port, and says so here:

- the CTC cost of an utterance is divided by its mel frames, as optax's is
  averaged, where ``nn.CTCLoss(reduction="mean")`` divides by its text length;
- the mel loss is masked by the mel lengths, where NVIDIA's masks
  ``mel_tgt != 0`` (the same on these N(0, 1) mels);
- the symbol embedding has no padding row: row 0 is a trained parameter,
  and the aligner's keys at padded positions are row 0, where NVIDIA's
  ``padding_idx=0`` keeps a zero row with no gradient;
- LAMB is optax's (``train/state.py``), where the recipe ran apex's
  ``FusedLAMB``: the learning rate is the noam schedule
  ``lr · min(s^-0.5, s · w^-1.5) · w^0.5`` at ``s = max(count, 1)``, counted
  from 0, where NVIDIA's ``adjust_learning_rate`` has no ``w^0.5`` factor;
  the gradient is clipped only at ``grad_clip_norm`` (FusedLAMB also clips
  its global norm at 1.0 by default); accumulation averages the micro-steps'
  gradients before the clip; the trust ratio ``|p| / |u|`` (1 where either
  is 0) scales every leaf, as FusedLAMB's does with a weight decay on all.

Dropout is the caller's: ``drop(x, p)`` returns ``x`` with a keep-mask
applied and scaled by ``1 / (1 - p)``, called in the program's order (per
encoder and decoder layer: the attention probabilities, the attention
output, the feed-forward output; then each predictor layer's output).
:class:`Given` applies the masks the program drew; :class:`Drawn` draws
them from a generator (the control, which has no program to follow).
Nothing here imports the port or JAX.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.nn import functional as F

from .nets import Arith, FastPitchRef, _positions, _same_conv, leaf_norms

__all__ = ["TERMS", "build", "Given", "Drawn", "Misfit", "beta_binomial_prior", "mas_width1",
           "mas", "micro_step", "first_steps"]

TERMS = ("loss", "mel_loss", "duration_predictor_loss", "pitch_loss", "energy_loss", "attn_loss",
         "kl_loss")
TEMPERATURE = 0.0005
BLANK_LOGPROB = -1.0
NEG = -1e9


class Misfit(ValueError):
    """What the program recorded does not fit the batch it was given."""


def build(cfg: dict, device) -> dict:
    return {"fastpitch": FastPitchRef(cfg["fastpitch"]).to(device)}


class Given:
    """Dropout with the keep-masks the program drew, in its order."""

    def __init__(self, masks: Sequence[torch.Tensor]):
        self.masks, self.used = list(masks), 0

    def __call__(self, x: torch.Tensor, p: float) -> torch.Tensor:
        if self.used >= len(self.masks) or self.masks[self.used].shape != x.shape:
            raise Misfit(f"dropout {self.used}: {tuple(x.shape)} against the program's "
                         f"{[tuple(m.shape) for m in self.masks[self.used:self.used + 1]]}")
        keep = self.masks[self.used].to(x.device)
        self.used += 1
        return torch.where(keep, x / (1.0 - p), torch.zeros((), device=x.device))


class Drawn:
    """Dropout drawn from ``generator`` (keep where a uniform draw is below
    ``1 - p``), each keep-mask kept in ``masks``."""

    def __init__(self, generator: torch.Generator):
        self.generator, self.masks = generator, []

    def __call__(self, x: torch.Tensor, p: float) -> torch.Tensor:
        keep = torch.rand(tuple(x.shape), generator=self.generator, device=x.device) < 1.0 - p
        self.masks.append(keep)
        return torch.where(keep, x / (1.0 - p), torch.zeros((), device=x.device))


def _drop(x, p: float, drop):
    return x if p == 0.0 else drop(x, p)


# ------------------------------------------------------------------ forward

def _stack(a: Arith, stack, x, mask, p: float, p_att: float, drop):
    """An FFT stack over [B, T, d] with the key mask [B, T]: post-LN
    attention (a -1e9 bias on padded keys) and conv feed-forward, each
    output masked."""
    b, t, d = x.shape
    m = mask[..., None].float()
    x = x + torch.as_tensor(_positions(t, d), device=x.device)[None] * m
    bias = torch.where(mask, 0.0, NEG)[:, None, None, :]
    for layer in stack.layers:
        at, ff = layer.attn, layer.ff
        q, k, v = a.linear(x, at.qkv.weight, at.qkv.bias).view(
            b, t, 3, at.heads, at.d_head).unbind(2)
        score = a.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(at.d_head) + bias
        prob = _drop(torch.softmax(score, -1), p_att, drop)
        out = a.einsum("bhqk,bkhd->bqhd", prob, v).reshape(b, t, -1)
        x = at.layer_norm(x + _drop(a.linear(out, at.o.weight), p, drop)) * m
        y = _same_conv(a, ff.conv2, torch.relu(_same_conv(a, ff.conv1, x)))
        x = ff.layer_norm(x + _drop(y, p, drop)) * m
    return x


def _predictor(a: Arith, pred, x, mask, p: float, drop):
    """conv → ReLU → LayerNorm → dropout per layer, then the linear head,
    masked: [B, T, d] → [B, T, 1]."""
    m = mask[..., None].float()
    x = x * m
    for layer in pred.layers:
        x = _drop(layer.norm(torch.relu(_same_conv(a, layer.conv, x))), p, drop)
    return a.linear(x, pred.fc.weight, pred.fc.bias) * m


def beta_binomial_prior(in_lens, out_lens, t_text: int, t_mel: int) -> torch.Tensor:
    """NVIDIA's ``beta_binomial_prior_distribution`` (scipy's ``betabinom(P,
    i, M + 1 - i).pmf(k)`` for mel frame ``i`` in 1..M, ``k`` in 0..P-1) of
    each utterance, zero-padded to [B, t_mel, t_text], computed in float64
    from ``lgamma``, returned in f32."""
    dev = in_lens.device
    i = torch.arange(1, t_mel + 1, dtype=torch.float64, device=dev)[None, :, None]
    k = torch.arange(t_text, dtype=torch.float64, device=dev)[None, None, :]
    m = out_lens.double()[:, None, None]
    n = in_lens.double()[:, None, None]
    valid = (i <= m) & (k < n)
    b = torch.where(valid, m + 1.0 - i, 1.0)
    nk = torch.where(valid, n - k, 1.0)
    lg = torch.lgamma
    log_pmf = (lg(n + 1.0) - lg(k + 1.0) - lg(nk + 1.0) + lg(k + i) + lg(nk + b)
               - lg(n + i + b) - lg(i) - lg(b) + lg(i + b))
    return torch.where(valid, torch.exp(log_pmf), 0.0).float()


def _align(a: Arith, al, mel, emb, text_mask, prior):
    """The aligner: ``(soft attention, log-probabilities)``, both [B, T_mel,
    T_text]; the soft attention masks padded keys."""
    k = _same_conv(a, al.key_conv2, torch.relu(_same_conv(a, al.key_conv1, emb)))
    q = torch.relu(_same_conv(a, al.query_conv1, mel))
    q = _same_conv(a, al.query_conv3, torch.relu(_same_conv(a, al.query_conv2, q)))
    dist = ((q[:, :, None, :] - k[:, None, :, :]) ** 2).sum(-1)
    logprob = torch.log_softmax(-TEMPERATURE * dist, -1) + torch.log(prior + 1e-8)
    soft = torch.softmax(logprob.masked_fill(~text_mask[:, None, :], float("-inf")), -1)
    return soft, logprob


def _average(x, dur):
    """NVIDIA's ``average_pitch``: the mean of the nonzero values of
    ``x [B, F, T_mel]`` over each token's frames (``dur [B, T_text]``), 0
    where a token has none; sums in float64."""
    ends = dur.cumsum(1).long()
    starts = F.pad(ends[:, :-1], (1, 0))
    sums = F.pad(x.double().cumsum(2), (1, 0))
    nonzero = F.pad((x != 0).double().cumsum(2), (1, 0))
    shape = (x.shape[0], x.shape[1], dur.shape[1])
    e, s = ends[:, None].expand(shape), starts[:, None].expand(shape)
    total = sums.gather(2, e) - sums.gather(2, s)
    count = nonzero.gather(2, e) - nonzero.gather(2, s)
    return torch.where(count == 0, 0.0, total / count.clamp_min(1.0)).float()


def _mse(pred, target, mask):
    sq = (pred - target) ** 2 * mask
    return sq.sum() / mask.expand(sq.shape).sum().clamp_min(1.0)


def micro_step(net: FastPitchRef, a: Arith, batch: dict, scales: dict, drop: Callable,
               path_of: Callable):
    """The training forward and losses of one batch (the program's keys:
    ``text``, ``input_lens``, ``mel``, ``mel_lens``, ``pitch``, ``energy``).
    ``path_of(mas_in, in_lens, out_lens)`` gives the hard alignment for
    MAS's input ``log(soft + 1e-12)``. Returns ``(terms, mas_in, path)``,
    ``terms`` the losses of :data:`TERMS` as 0-d tensors."""
    c = net.cfg
    text, mel = batch["text"].long(), batch["mel"].float()
    in_lens, out_lens = batch["input_lens"].long(), batch["mel_lens"].long()
    b, t_text = text.shape
    t_mel = mel.shape[1]
    dev = text.device
    text_mask = text != 0
    emb = a.q(net.encoder.word_emb.weight[text])
    enc = _stack(a, net.encoder, emb, text_mask, c["p_in_fft_dropout"], c["p_in_fft_dropatt"],
                 drop)
    log_dur = _predictor(a, net.duration_predictor, enc, text_mask,
                         c["p_dur_predictor_dropout"], drop)[..., 0]
    pitch_pred = _predictor(a, net.pitch_predictor, enc, text_mask,
                            c["p_pitch_predictor_dropout"], drop).transpose(1, 2)

    prior = beta_binomial_prior(in_lens, out_lens, t_text, t_mel)
    soft, logprob = _align(a, net.attention, mel, emb, text_mask, prior)
    mas_in = torch.log(soft.detach() + 1e-12)
    path = path_of(mas_in, in_lens, out_lens)
    dur = path.sum(1)

    pitch_tgt = _average(batch["pitch"][:, :, :t_mel].float(), dur)
    enc = enc + _same_conv(a, net.pitch_emb, pitch_tgt.transpose(1, 2))
    energy_pred = _predictor(a, net.energy_predictor, enc, text_mask,
                             c["p_energy_predictor_dropout"], drop)[..., 0]
    energy_tgt = torch.log(1.0 + _average(batch["energy"][:, None, :t_mel].float(), dur))
    enc = enc + _same_conv(a, net.energy_emb, energy_tgt.transpose(1, 2))

    dec_lens = dur.sum(1).long().clamp(max=t_mel)
    frames = torch.arange(t_mel, device=dev)[None] < dec_lens[:, None]
    token = path.argmax(-1)  # the token of each frame; rows past the path are masked
    x = enc.gather(1, token[..., None].expand(-1, -1, enc.shape[-1])) * frames[..., None]
    y = _stack(a, net.decoder, x, frames, c["p_out_fft_dropout"], c["p_out_fft_dropatt"], drop)
    mel_out = a.linear(y, net.proj.weight, net.proj.bias)

    text_m = text_mask.float()
    mel_m = (torch.arange(t_mel, device=dev)[None] < out_lens[:, None]).float()[..., None]
    padded = F.pad(logprob, (1, 0), value=BLANK_LOGPROB)
    ctc = []
    for u in range(b):
        n_mel, n_text = int(out_lens[u]), int(in_lens[u])
        lp = torch.log_softmax(padded[u, :n_mel, :n_text + 1], -1)
        cost = F.ctc_loss(lp[:, None], torch.arange(1, n_text + 1, device=dev)[None],
                          [n_mel], [n_text], blank=0, reduction="sum")
        ctc.append(cost / max(n_mel, 1))
    hard = path == 1.0
    terms = {
        "mel_loss": _mse(mel_out, mel, mel_m),
        "duration_predictor_loss": _mse(log_dur, torch.log(dur + 1.0), text_m),
        "pitch_loss": _mse(pitch_pred, pitch_tgt, text_m[:, None, :]),
        "energy_loss": _mse(energy_pred, energy_tgt[:, 0], text_m),
        "attn_loss": torch.stack(ctc).mean(),
        "kl_loss": -torch.where(hard, torch.log(soft.clamp_min(1e-12)), 0.0).sum()
        / path.sum().clamp_min(1.0),
    }
    terms["loss"] = (terms["mel_loss"]
                     + scales["dur_predictor_loss_scale"] * terms["duration_predictor_loss"]
                     + scales["pitch_predictor_loss_scale"] * terms["pitch_loss"]
                     + scales["energy_predictor_loss_scale"] * terms["energy_loss"]
                     + scales["attn_loss_scale"] * terms["attn_loss"]
                     + scales["attn_kl_scale"] * terms["kl_loss"])
    return terms, mas_in, path


# ---------------------------------------------------------------------- MAS

def mas_width1(log_attn: np.ndarray) -> np.ndarray:
    """NVIDIA's ``alignment.py::mas_width1`` on one utterance's [T_mel,
    T_text] log-attention at its own lengths: the Viterbi sums in float32,
    row 0 reaching text position 0 only, the diagonal taken where it is at
    least the stay; the one-hot path backtracked from the last position."""
    t_mel, t_text = log_attn.shape
    log_p = np.array(log_attn, dtype=np.float32)
    log_p[0, 1:] = -np.inf
    diag = np.zeros((t_mel, t_text), bool)
    shifted = np.empty(t_text, np.float32)
    for i in range(1, t_mel):
        prev = log_p[i - 1]
        shifted[0], shifted[1:] = -np.inf, prev[:-1]
        diag[i] = shifted >= prev
        log_p[i] += np.where(diag[i], shifted, prev)
    path = np.zeros((t_mel, t_text), np.float32)
    j = t_text - 1
    for i in range(t_mel - 1, -1, -1):
        path[i, j] = 1.0
        j -= int(diag[i, j])
    return path


def mas(log_attn: torch.Tensor, in_lens, out_lens) -> torch.Tensor:
    """:func:`mas_width1` of each utterance of ``log_attn [B, T_mel,
    T_text]`` at its lengths, zero-padded, on ``log_attn``'s device."""
    la = log_attn.detach().float().cpu().numpy()
    out = np.zeros(la.shape, np.float32)
    for u, (n_text, n_mel) in enumerate(zip(in_lens.tolist(), out_lens.tolist())):
        out[u, :n_mel, :n_text] = mas_width1(la[u, :n_mel, :n_text])
    return torch.as_tensor(out, device=log_attn.device)


# --------------------------------------------------------------------- LAMB

class Lamb:
    """optax's ``chain(clip_by_global_norm(c), lamb)`` as ``train/state.py``
    documents it, on a list of f32 leaves (the accumulation is the caller's)."""

    def __init__(self, params: List[torch.Tensor], o: dict):
        self.params, self.o, self.count = params, o, 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    def lr(self, count: int) -> float:
        o = self.o
        if o["schedule"] != "noam":
            raise ValueError(f"the reference has the noam schedule only, not {o['schedule']!r}")
        s, w = max(count, 1), o["warmup_steps"]
        return o["learning_rate"] * min(s ** -0.5, s * w ** -1.5) * w ** 0.5

    @torch.no_grad()
    def clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        c = self.o["grad_clip_norm"]
        norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads)))
        return grads if c is None or norm < c else [g * (c / norm) for g in grads]

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor]):
        o = self.o
        lr, b1, b2 = self.lr(self.count), o["beta1"], o["beta2"]
        self.count += 1
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            u = (m / (1.0 - b1 ** self.count)) / ((v / (1.0 - b2 ** self.count)).sqrt()
                                                  + o["eps"]) + o["weight_decay"] * p
            p_norm, u_norm = float(p.norm()), float(u.norm())
            ratio = p_norm / u_norm if p_norm > 0 and u_norm > 0 else 1.0
            p.sub_(lr * ratio * u)


def first_steps(cfg: dict, mix: dict, nets: dict, batches: Sequence[dict], a: Arith,
                recorded: Optional[dict] = None, generator: Optional[torch.Generator] = None):
    """The micro-steps of ``batches`` from the loaded weights, the gradients
    of every ``grad_accum_steps`` of them averaged, clipped and given to
    LAMB. With ``recorded`` (per micro-step ``masks`` and ``paths``, the
    program's) the steps follow the program's dropout and MAS path; without
    it they draw their masks from ``generator`` and take their own MAS path.

    Returns ``losses`` (per micro-step, :data:`TERMS`), ``grad_at`` (each
    leaf's first update's clipped gradient) and ``grad`` (its norm),
    ``update_at`` (each leaf's change after the last update) and ``update``
    (its norm), and per micro-step ``mas_in``,
    ``paths``, ``masks`` and ``lens`` (text and mel lengths)."""
    net = nets["fastpitch"]
    o, k = mix["optimizer"], int(mix["optimizer"]["grad_accum_steps"])
    named = [(f"fastpitch.{n}", p) for n, p in net.named_parameters()]
    params = [p for _, p in named]
    start = [p.detach().clone() for p in params]
    opt = Lamb(params, o)
    out = {key: [] for key in ("losses", "mas_in", "paths", "masks", "lens")}
    acc, grad = None, None
    with a.flags():
        for i, batch in enumerate(batches):
            if recorded is None:
                drop, path_of = Drawn(generator), mas
            else:
                drop = Given(recorded["masks"][i])

                def path_of(mas_in, in_lens, out_lens, given=recorded["paths"][i]):
                    if given.shape != mas_in.shape:
                        raise Misfit(f"MAS path {tuple(given.shape)} against the batch's "
                                     f"{tuple(mas_in.shape)}")
                    return given.to(mas_in.device, torch.float32)
            for p in params:
                p.grad = None
            terms, mas_in, path = micro_step(net, a, batch, mix["loss"], drop, path_of)
            if recorded is not None and drop.used != len(drop.masks):
                raise Misfit(f"the program drew {len(drop.masks)} dropout masks, the "
                             f"forward applies {drop.used}")
            terms["loss"].backward()
            out["losses"].append([float(terms[t].detach()) for t in TERMS])
            out["mas_in"].append(mas_in)
            out["paths"].append(path)
            out["masks"].append(drop.masks)
            out["lens"].append((batch["input_lens"].long(), batch["mel_lens"].long()))
            g = [p.grad.detach().clone() if p.grad is not None else torch.zeros_like(p)
                 for p in params]
            acc = g if acc is None else [x + y for x, y in zip(acc, g)]
            if (i + 1) % k == 0:
                clipped = opt.clip([x / k for x in acc])
                acc = None
                if grad is None:
                    out["grad_at"] = {n: x for (n, _), x in zip(named, clipped)}
                    grad = leaf_norms(out["grad_at"])
                opt.update(clipped)
    out["grad"] = grad
    out["update_at"] = {n: p.detach() - s for (n, p), s in zip(named, start)}
    out["update"] = leaf_norms(out["update_at"])
    return out
