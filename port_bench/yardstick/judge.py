"""The comparisons that decide ``correct``.

Serving (:func:`serving_numbers`): for each sampled utterance the reference
works out again, in f32, the token ids from the raw text, the predicted
durations, and, following the served durations (the program's decisions,
as a served model's tokens are followed), the mel, and from the served mel
the audio. Numbers:

- ``ids``: utterances whose ids differ from the reference's (exact: 0);
- ``frames``: utterances that were never served, or whose served length is
  not the sum of their served durations rounded (exact: 0);
- ``dur``: the widest gap ``|d − d_ref| / (d_ref + 1)`` of a token's
  predicted duration (frames);
- ``mel``: the widest ``max|mel − mel_ref| / max|mel_ref|`` of an utterance;
- ``audio``: the same of the audio, the reference vocoding the served mel
  (as it follows the served durations; ``mel`` checks that stage) at the
  frames the program's vocoder was given (its batch's bucket).

Training (:func:`training_numbers`): the first step's two losses
(``loss1``: the same weights on both sides, so only the arithmetic
differs), each of the first three steps' losses (``loss``), the first
gradient as the optimizer holds it, and the parameters' change after three
steps, the last two by the worst leaf against the reference's norm of that
leaf or the median leaf's, whichever is larger. Leaves whose reference
gradient is under a thousandth of the median leaf's move by rounding alone
and are left out of both.

FastPitch training (:func:`fastpitch_training_numbers`) compares ``mas``,
the compared micro-steps' utterances whose MAS path differs from the plain
MAS run on the program's own MAS input (exact: 0); ``loss``, each
micro-step's total loss, and ``loss1.ctc``, the first micro-step's CTC
term; ``grad``, the first update's gradient (the micro-steps' mean after
the clip) by the worst leaf and ``grad.median`` by the median leaf; and
``update`` after the compared updates. LAMB scales each leaf's update to
its parameter's norm, and the gradient of half of the rows has about the
norm of all of them, so the norms miss a wrong gradient: ``grad.diff`` and
``update.diff`` compare the median leaf's norm of the difference, against
the larger of the reference's norm of that leaf and the median leaf's.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..reference.nets import Arith, round_durations
from . import weights

__all__ = ["serving_numbers", "judge_serving", "training_numbers",
           "fastpitch_training_numbers", "worst_leaves", "verdict"]


def _finite(v: float) -> float:
    """A reading that is not a number reads as infinitely wrong."""
    return float(v) if np.isfinite(v) else float("inf")


def _rel_max(x: np.ndarray, ref: np.ndarray) -> float:
    if x.shape != ref.shape or x.size == 0:
        return float("inf")
    scale = float(np.max(np.abs(ref)))
    return _finite(float(np.max(np.abs(x - ref))) / scale if scale > 0 else np.max(np.abs(x)))


def serving_numbers(ref, nets: dict, cfg: dict, mix: dict, utterances: List[dict],
                    device) -> Dict[str, float]:
    """The serving numbers of ``utterances`` (dicts of ``text``, ``ids``,
    ``mel`` and, where it was served, ``width`` and ``vocoder_frames``, the
    padded text width and the vocoder frames of its batch, ``durations`` and
    ``audio``) against the f32 reference ``nets``."""
    a = Arith("f32")
    max_len = int(mix["max_mel_len"])
    out = {"ids": 0.0, "frames": 0.0, "dur": 0.0, "mel": 0.0, "audio": 0.0}
    for u in utterances:
        ids = np.asarray(ref.encode(cfg, u["text"]), np.int64)
        if ids.shape != np.shape(u["ids"]) or np.any(ids != np.asarray(u["ids"])):
            out["ids"] += 1
            continue
        if u["mel"] is None:
            out["frames"] += 1
            continue
        enc, dur = ref.durations(nets, a, torch.as_tensor(ids, device=device), u["width"])
        dur = dur.cpu().numpy().astype(np.float64)
        served = np.asarray(u["durations"], np.float64)
        if served.shape != dur.shape:
            out["dur"] = float("inf")
            continue
        out["dur"] = max(out["dur"], _finite(np.max(np.abs(served - dur) / (dur + 1.0))))
        reps = round_durations(torch.as_tensor(served))
        n = min(int(reps.sum()), max_len)
        if n != len(u["mel"]) or (u["audio"] is not None and len(u["audio"]) != n * cfg["vocoder"]["hop_size"]):
            out["frames"] += 1
            continue
        mel = ref.decode(nets, a, enc, reps.to(device), max_len)
        out["mel"] = max(out["mel"], _rel_max(np.asarray(u["mel"]), mel.cpu().numpy()))
        served = torch.as_tensor(np.asarray(u["mel"], np.float32), device=device)
        audio = ref.vocode(nets, a, served, int(u["vocoder_frames"])).cpu().numpy()
        out["audio"] = max(out["audio"], _rel_max(np.asarray(u["audio"]), audio))
    return out


def reference_nets(ref, cfg: dict, seed: int, device, init_weights, program_leaves=None):
    """The reference's networks with the seeded weights; with
    ``program_leaves``, raises unless the program has the same leaves (one
    seed then gives both sides the same weights)."""
    nets = ref.build(cfg, device)
    leaves = sorted((f"{k}.{n}", s) for k, net in nets.items() for n, s in weights.spec(net))
    if program_leaves is not None and leaves != sorted(program_leaves):
        raise KeyError(f"the reference's leaves differ from the program's: "
                       f"{sorted(set(leaves) ^ set(program_leaves))[:4]}")
    w = init_weights(cfg, leaves, seed, device)
    for k, net in nets.items():
        weights.load(net, {n[len(k) + 1:]: v for n, v in w.items() if n.startswith(k + ".")})
    return nets


def judge_serving(ref, cfg, mix, seed, device, utterances, limits, init_weights, leaves):
    nets = reference_nets(ref, cfg, seed, device, init_weights, leaves)
    return verdict(serving_numbers(ref, nets, cfg, mix, utterances, device), limits)


def leaf_gaps(prog: Dict[str, float], refn: Dict[str, float], keep) -> Dict[str, float]:
    """Each kept leaf's gap of norms against the larger of its reference
    norm and the median kept leaf's."""
    med = float(np.median([refn[k] for k in keep])) if keep else 0.0
    if set(prog) != set(refn):
        return {"(leaves differ)": float("inf")}
    return {k: _finite(abs(prog[k] - refn[k]) / max(refn[k], med, 1e-30)) for k in keep}


def _gaps(prog, refn, keep) -> float:
    return max(leaf_gaps(prog, refn, keep).values(), default=0.0)


def kept_leaves(refr: dict):
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    gmed = float(np.median(list(refr["grad"].values())))
    return [k for k, g in refr["grad"].items() if g >= 1e-3 * gmed]


def training_numbers(prog: dict, refr: dict) -> Dict[str, float]:
    """``prog`` and ``refr`` each hold ``losses`` (per step, a list of
    floats), ``grad`` and ``update`` (leaf → norm); ``refr`` decides the
    leaves that count."""
    keep = kept_leaves(refr)
    gaps = [[_finite(abs(p - r) / max(abs(r), 1e-30)) for p, r in zip(ps, rs)]
            for ps, rs in zip(prog["losses"], refr["losses"])]
    return {"loss1": max(gaps[0]), "loss": max(max(g) for g in gaps),
            "grad": _gaps(prog["grad"], refr["grad"], keep),
            "update": _gaps(prog["update"], refr["update"], keep)}


def fastpitch_training_numbers(prog: dict, refr: dict, plain_mas, terms) -> Dict[str, float]:
    """``prog`` holds per micro-step the program's MAS input and path
    (``mas_in``, ``paths``, [B, T_mel, T_text]); both hold ``losses``, per
    micro-step the loss terms named by ``terms``, the total first, the
    first update's gradient and the change after the last update by leaf
    (``grad_at``, ``update_at``) and their norms (``grad``, ``update``), and
    ``refr`` the lengths, ``lens``; ``plain_mas(log_attn, in_lens,
    out_lens)`` is the reference's MAS."""
    wrong = 0.0
    for mas_in, path, (in_lens, out_lens) in zip(prog["mas_in"], prog["paths"], refr["lens"]):
        plain = plain_mas(mas_in.to(in_lens.device), in_lens, out_lens)
        wrong += float((plain != path.to(plain.device)).flatten(1).any(1).sum())
    keep = kept_leaves(refr)
    grad = leaf_gaps(prog["grad"], refr["grad"], keep)
    gdiff = leaf_diffs(prog["grad_at"], refr["grad_at"], refr["grad"], keep)
    udiff = leaf_diffs(prog["update_at"], refr["update_at"], refr["update"], keep)
    ctc = terms.index("attn_loss")
    p1, r1 = prog["losses"][0][ctc], refr["losses"][0][ctc]
    return {"mas": wrong,
            "loss": max(_finite(abs(p[0] - r[0]) / max(abs(r[0]), 1e-30))
                        for p, r in zip(prog["losses"], refr["losses"])),
            "loss1.ctc": _finite(abs(p1 - r1) / max(abs(r1), 1e-30)),
            "grad": max(grad.values(), default=0.0),
            "grad.median": float(np.median(list(grad.values()))) if grad else 0.0,
            "grad.diff": float(np.median(list(gdiff.values()))) if gdiff else 0.0,
            "update": _gaps(prog["update"], refr["update"], keep),
            "update.diff": float(np.median(list(udiff.values()))) if udiff else 0.0}


def leaf_diffs(prog: Dict[str, torch.Tensor], refr: Dict[str, torch.Tensor],
               refn: Dict[str, float], keep) -> Dict[str, float]:
    """Each kept leaf's norm of the difference of the program's tensor and
    the reference's, against the larger of the reference's norm of that leaf
    and the median kept leaf's."""
    med = float(np.median([refn[k] for k in keep])) if keep else 0.0
    if set(prog) != set(refr):
        return {"(leaves differ)": float("inf")}
    out = {}
    for k in keep:
        r = refr[k].double()
        d = torch.linalg.vector_norm(prog[k].to(r.device).double() - r)
        out[k] = _finite(float(d) / max(refn[k], med, 1e-30))
    return out


def worst_leaves(prog: dict, refr: dict, n: int = 3) -> dict:
    """The leaves left out by :func:`kept_leaves` and the ``n`` widest gaps
    of ``grad`` and ``update``: where a failing number comes from."""
    keep = kept_leaves(refr)
    out = {"left_out": sorted(set(refr["grad"]) - set(keep))}
    for key in ("grad", "update"):
        gaps = leaf_gaps(prog[key], refr[key], keep)
        out[key] = sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """``[(name, value, limit)]`` for every limited number; a number with no
    limit is an error in the cell's files, not a pass."""
    missing = sorted(set(numbers) - set(limits))
    if missing:
        raise KeyError(f"no limit for {missing}")
    return [(k, float(numbers[k]), float(limits[k])) for k in numbers]
