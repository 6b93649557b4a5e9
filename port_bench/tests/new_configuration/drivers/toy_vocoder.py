"""The stand-in configuration's driver (``toy-vocoder``), for the test that a
cell of a new configuration lands as files alone. Two ``torch.nn.Linear``
layers map each mel frame to a hop of samples and stand in for the
program; each call is marked with the program's span and counter
(``utils/profiling.py``), as the program's models mark their own. Batches of
frames are drawn on the device from the seed and cycled in a closed loop;
the check compares the window's first batches with the reference's."""

from __future__ import annotations

import time

import torch

from ..reference import load_reference
from ..reference.nets import Arith
from ..yardstick import weights
from ..yardstick.judge import verdict

__all__ = ["ToyVocoder", "Driver", "control"]


def init_weights(cfg: dict, leaves, seed: int, device):
    """The seeded weights by the configuration's rule, with the output
    layer scaled: a configuration adjusts its leaves in its own driver."""
    out = weights.make(leaves, seed, device, cfg["init"]["rule"])
    out["2.weight"].mul_(cfg["init"]["output_scale"])
    return out


def frames(cfg: dict, mix: dict, seed: int, device) -> torch.Tensor:
    """``[pool_batches, batch, n_mels]`` frames, N(0, 1), from the seed."""
    t = cfg["toy"]
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    return torch.randn(int(mix["pool_batches"]), int(t["batch"]), int(t["n_mels"]),
                       generator=gen, device=device)


def gap(got, want) -> float:
    """The widest ``max|y − y_ref| / max|y_ref|`` of a batch; infinite where
    a batch is missing or a reading is not a number."""
    if not want or len(got) != len(want):
        return float("inf")
    v = max(float((y - r).abs().max() / r.abs().max()) for y, r in zip(got, want))
    return v if v == v else float("inf")


class ToyVocoder:
    def __init__(self, cell: dict, config: dict, mix: dict, device: torch.device, seed: int,
                 root):
        self.cell, self.cfg, self.mix = cell, config, mix
        self.device, self.seed, self.root = device, int(seed), root
        self.extras: dict = {}

    def setup(self):
        t = self.cfg["toy"]
        self.net = torch.nn.Sequential(torch.nn.Linear(t["n_mels"], t["hidden"]), torch.nn.Tanh(),
                                       torch.nn.Linear(t["hidden"], t["hop"])).to(self.device)
        weights.load(self.net, init_weights(self.cfg, weights.spec(self.net), self.seed,
                                            self.device))
        self.pool = frames(self.cfg, self.mix, self.seed, self.device)
        self._call(self.pool[0])  # the one shape, warmed

    def _call(self, x: torch.Tensor) -> torch.Tensor:
        from neuraltexttospeech_torch.utils import profiling

        with torch.no_grad(), profiling.span("toy.forward"):
            profiling.count("toy.frames", x.shape[0])
            return self.net(x)

    def window(self, seconds: float, profile_units: int = 0):
        from .serve import _Profiler, _sync

        prof = _Profiler(self.device) if profile_units else None
        n, check = self.pool.shape[0], int(self.mix["check_batches"])
        self.kept, k = [], 0
        _sync(self.device)
        if prof is not None:
            prof.start()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            y = self._call(self.pool[k % n])
            if k < check:
                self.kept.append(y)
            k += 1
            if prof is not None and k == profile_units:
                prof.stop()
        _sync(self.device)
        t_close = time.perf_counter()
        if prof is not None and prof.running:
            prof.stop()
        self.extras.update(window_s=t_close - t0, attempted=k, failed=0,
                           trace=prof.trace() if prof else None,
                           trace_units=min(profile_units, k))

    def end_to_end(self) -> dict:
        t = self.cfg["toy"]
        audio = self.extras["attempted"] * t["batch"] * t["hop"] / t["sampling_rate"]
        return {"serve_audio_s_per_s": audio / self.extras["window_s"]}

    def check(self, limits: dict):
        ref = load_reference(self.root, self.cell["config"])
        w = init_weights(self.cfg, ref.leaves(self.cfg), self.seed, self.device)
        want = [ref.forward(w, self.pool[i]) for i in range(len(self.kept))]
        return verdict({"audio": gap(self.kept, want)}, limits)


def control(cell, seed: int, device):
    """The reference with TF32 operands in the program's place (the
    configuration is f32 with TF32 off), judged against its f32 self on the
    batches a run checks. Returns ``(numbers, {})``."""
    ref = load_reference(cell.root, cell.cell["config"])
    w = init_weights(cell.config, ref.leaves(cell.config), seed, device)
    pool = frames(cell.config, cell.mix, seed, device)[: int(cell.mix["check_batches"])]
    low = [ref.forward(w, x, Arith("tf32")) for x in pool]
    return {"audio": gap(low, [ref.forward(w, x) for x in pool])}, {}


Driver = ToyVocoder
