"""HiFi-GAN training cells: the port's three-optimizer GAN step
(``models/hifigan_gan.py::HiFiGANTrainer.train_step``) in a closed loop on
audio-only batches made on the card from the seed, so the step computes its
log-mels through kernel B1 and the MSD's grouped convs through kernel B2.

Set-up builds one trainer, loads the seeded weights into it, and drives it
through its first three steps on three distinct batches, reading the losses,
the first gradient from the generator's and discriminators' Adam state and
the parameters' change; the same trainer then runs the window.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from ..reference.nets import leaf_norms
from ..yardstick import synth, weights
from ..yardstick.judge import kept_leaves, leaf_gaps, training_numbers, verdict

__all__ = ["GanTrain", "NETS", "Driver", "control"]

NETS = ("gen", "mpd", "msd")


def init_weights(cfg: dict, leaves, seed: int, device) -> Dict[str, torch.Tensor]:
    return weights.make(leaves, seed, device, cfg["init"]["rule"])


def sn_buffers(msd: torch.nn.Module) -> List[str]:
    return [n for n, _ in msd.named_buffers() if n.endswith(".u")]


def leaves_of(nets: Dict[str, torch.nn.Module]):
    return [(f"{k}.{n}", s) for k in NETS
            for n, s in weights.spec(nets[k], sn_buffers(nets[k]) if k == "msd" else ())]


def load_all(nets: Dict[str, torch.nn.Module], w: Dict[str, torch.Tensor]):
    for k in NETS:
        weights.load(nets[k], {n[len(k) + 1:]: v for n, v in w.items() if n.startswith(k + ".")})


def params_of(nets) -> Dict[str, torch.Tensor]:
    return {f"{k}.{n}": p for k in NETS for n, p in nets[k].named_parameters()}


class GanTrain:
    def __init__(self, cell: dict, config: dict, mix: dict, device: torch.device, seed: int,
                 root):
        self.cell, self.cfg, self.mix = cell, config, mix
        self.device, self.seed, self.root = device, int(seed), root
        self.h = config["hifigan"]
        self.batch, self.segment = int(self.h["batch_size"]), int(self.h["segment_size"])
        self.extras: dict = {}

    def setup(self):
        from neuraltexttospeech_torch.models.hifigan import HiFiGANConfig
        from neuraltexttospeech_torch.models.hifigan_gan import HiFiGANTrainer

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        fields = set(HiFiGANConfig.__dataclass_fields__)
        kw = {k: (tuple(tuple(x) if isinstance(x, list) else x for x in v)
                  if isinstance(v, list) else v) for k, v in self.h.items() if k in fields}
        self.trainer = HiFiGANTrainer(HiFiGANConfig(**kw), self.device,
                                      steps_per_epoch=int(self.mix["steps_per_epoch"]),
                                      dtype=None)
        nets = {k: getattr(self.trainer, k) for k in NETS}
        self.leaves = leaves_of(nets)
        load_all(nets, init_weights(self.cfg, self.leaves, self.seed, self.device))
        n = int(self.mix["pool_batches"])
        self.pool = synth.synthetic_wavs_device(n * self.batch, self.segment, self.seed ^ 0xDA7A,
                                                self.device).view(n, self.batch, self.segment, 1)
        self.readings = self._first_steps(nets)

    def _first_steps(self, nets) -> dict:
        """Three steps through the window's own call, each on its own batch."""
        params = params_of(nets)
        start = {k: p.detach().clone() for k, p in params.items()}
        losses, grad = [], None
        b1 = float(self.h["adam_b1"])
        for i in range(3):
            m = self.trainer.train_step({"audio": self.pool[i]})
            losses.append([float(m["gen_loss"]), float(m["disc_loss"])])
            if i == 0:
                state = {}
                for k in NETS:
                    opt = self.trainer.optimizers[k]
                    for n, p in nets[k].named_parameters():
                        st = opt.state.get(p, {})
                        state[f"{k}.{n}"] = (st["exp_avg"] / (1 - b1) if "exp_avg" in st
                                             else torch.zeros_like(p))
                grad = leaf_norms(state)
        update = leaf_norms({k: p.detach() - start[k] for k, p in params.items()})
        del start
        return {"losses": losses, "grad": grad, "update": update}

    def window(self, seconds: float, profile_units: int = 0):
        from .serve import _Profiler, _sync

        prof = _Profiler(self.device) if profile_units else None
        n_pool = self.pool.shape[0]
        metrics, issue = [], []
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        _sync(self.device)
        if prof is not None:
            prof.start()
        t0 = time.perf_counter()
        k = 0
        while time.perf_counter() - t0 < seconds:
            t = time.perf_counter()
            metrics.append(self.trainer.train_step({"audio": self.pool[(3 + k) % n_pool]}))
            issue.append(time.perf_counter() - t)
            k += 1
            if prof is not None and k == profile_units:
                prof.stop()
        _sync(self.device)
        t_close = time.perf_counter()
        if prof is not None and prof.running:
            prof.stop()
        finite = torch.stack([torch.isfinite(torch.stack([m["gen_loss"], m["disc_loss"]])).all()
                              for m in metrics]).cpu().numpy() if metrics else np.zeros(0, bool)
        self.extras.update(
            window_s=t_close - t0, attempted=k, failed=int((~finite).sum()),
            steps_ok=int(finite.sum()), issue_s=issue,
            peak_bytes=(torch.cuda.max_memory_allocated(self.device)
                        if self.device.type == "cuda" else 0),
            trace=prof.trace() if prof else None, trace_units=min(profile_units, k))
        return self.extras

    def end_to_end(self) -> dict:
        audio = self.extras["steps_ok"] * self.batch * self.segment / self.h["sampling_rate"]
        return {"train_audio_s_per_s": audio / self.extras["window_s"]}

    def free(self):
        self.trainer = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, limits: dict):
        from ..reference import load_reference

        batches = self.pool[:3].clone()
        self.pool = None
        self.free()
        ref = load_reference(self.root, self.cell["config"])
        refr = ref.first_steps(self.cfg, self.mix, self.seed, self.device, batches, "f32",
                               init_weights, self.leaves)
        keep = kept_leaves(refr)
        for key in ("grad", "update"):  # where a failing number comes from
            gaps = leaf_gaps(self.readings[key], refr[key], keep)
            print(f"worst leaves, {key}: {sorted(gaps.items(), key=lambda kv: -kv[1])[:3]}",
                  file=sys.stderr)
        return verdict(training_numbers(self.readings, refr), limits)


def control(cell, seed: int, device):
    """The control of the GAN training cells, for ``calibrate.py``: the
    reference's first three GAN steps with TF32 operands, judged against its
    own f32 steps. Returns ``(numbers, {"leaves": the worst leaves})``."""
    from ..reference import load_reference
    from ..yardstick.judge import worst_leaves

    cfg, mix = cell.config, cell.mix
    h = cfg["hifigan"]
    ref = load_reference(cell.root, cell.cell["config"])
    nets = ref.build(cfg, torch.device("cpu"))
    leaves = leaves_of(nets)
    n = int(mix["pool_batches"])
    pool = synth.synthetic_wavs_device(n * h["batch_size"], h["segment_size"], seed ^ 0xDA7A,
                                       device).view(n, h["batch_size"], h["segment_size"], 1)
    batches = pool[:3].clone()
    f32 = ref.first_steps(cfg, mix, seed, device, batches, "f32", init_weights, leaves)
    low = ref.first_steps(cfg, mix, seed, device, batches, "tf32", init_weights, leaves)
    return training_numbers(low, f32), {"leaves": worst_leaves(low, f32)}


Driver = GanTrain
