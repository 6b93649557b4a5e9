"""FastPitch training cells: the port's generic ``Trainer.train_step``
(``train/harness.py``) with the FastPitch CLI's loss
(``cli/fastpitch_train.py::make_loss_fn``: the training forward, MAS on the
card, the attention prior made on the card from the lengths) in a closed
loop, with the optimizer, the accumulation and the loss scales of the
traffic's recipe, the configuration's compute type (bf16: f32 weights and
optimizer state, as the CLI's ``--amp``), TF32 off as the CLI sets it, and
dropout on, drawn by the trainer's per-step generator.

The batches are a pool of ``pool_batches``, made in set-up from the seed and
cycled: each holds ``sentences_per_request`` whole LJSpeech transcripts
(``yardstick/traffic.py``: one from each length bin), encoded by the
benchmark's copy of the front end; an utterance's mel length is its token
count times a seeded draw from ``frames_per_token``, capped at
``max_mel_len``; the mels are N(0, 1), the pitch N(0, 1) on the frames a
seeded draw leaves voiced (``unvoiced_share`` of them 0), the energy the
mel's L2 norm over channels, as the port's dataset computes it; padded as
the dataset pads (``text_pad_multiple``, ``mel_pad_multiple``).

Set-up builds one trainer, loads the seeded weights and drives it through
its first ``checked_micro_steps`` micro-steps, each on its own pool batch,
through the window's own call, and records what the check needs: each
dropout keep-mask (drawn again from a copy of the step's generator just
before the program draws it), MAS's input and path (``maximum_path`` as
``models/fastpitch.py`` calls it), the loss terms, and each leaf's first
update's gradient (LAMB's first moment over ``1 - beta1``) and change,
whole and as norms; what is kept whole is kept on the host, out of the
window's memory. Then it runs the
pool's other batches once, so the window meets no new shape, and the same
trainer runs the window.

The untraced window is profiled whole for the card's records alone: the
seconds in which the card was busy give the rate the card sustains,
seconds of audio a second of device work, which the host's speed between
processes does not move.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict

import numpy as np
import torch

from ..reference import load_by_path, load_reference
from ..reference.nets import Arith, leaf_norms
from ..yardstick import traffic, weights
from ..yardstick.judge import fastpitch_training_numbers, reference_nets, verdict, worst_leaves

__all__ = ["FastPitchTrain", "Driver", "control", "make_pool", "init_weights", "train_reference"]

DTYPES = {"bf16": torch.bfloat16, "f32": None}


def init_weights(cfg: dict, leaves, seed: int, device) -> Dict[str, torch.Tensor]:
    return weights.make(leaves, seed, device, cfg["init"]["rule"])


def train_reference(root, config: str):
    """``reference/<config>.train.py``."""
    return load_by_path(root / "reference" / f"{config}.train.py", "port_bench.reference")


def make_pool(cfg: dict, mix: dict, seed: int, device, root):
    """``(batches, audio_s)``: the pool's batches, each a dict of the
    program's batch keys on ``device``, drawn from ``seed``, and each one's
    seconds of audio (its unpadded mel frames)."""
    encode = load_reference(root, "fastpitch-lj").encode
    stream = traffic.Sentences(mix, seed, root)
    rng = np.random.default_rng([int(seed), 0xF7A1])
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63 ^ 0x5EED)
    lo, hi = mix["frames_per_token"]
    cap, n_mel = int(mix["max_mel_len"]), int(cfg["fastpitch"]["n_mel_channels"])
    hop, sr = cfg["vocoder"]["hop_size"], cfg["vocoder"]["sampling_rate"]
    pool, audio_s = [], []
    for k in range(int(mix["pool_batches"])):
        ids = [np.asarray(encode(cfg, t), np.int32) for t in stream.request(k)]
        in_lens = np.array([len(i) for i in ids])
        mel_lens = np.minimum(np.rint(in_lens * rng.uniform(lo, hi, len(ids))), cap).astype(int)
        t_text = traffic.round_up(in_lens.max(), int(mix["text_pad_multiple"]))
        t_mel = traffic.round_up(mel_lens.max(), int(mix["mel_pad_multiple"]))
        text = np.zeros((len(ids), t_text), np.int32)
        for row, i in zip(text, ids):
            row[:len(i)] = i
        b = len(ids)
        ml = torch.as_tensor(mel_lens, dtype=torch.int32, device=device)
        frames = (torch.arange(t_mel, device=device)[None] < ml[:, None]).float()
        mel = torch.randn(b, t_mel, n_mel, generator=gen, device=device) * frames[..., None]
        voiced = torch.rand(b, 1, t_mel, generator=gen, device=device) >= mix["unvoiced_share"]
        pitch = torch.randn(b, 1, t_mel, generator=gen, device=device) * voiced * frames[:, None]
        pool.append({"text": torch.as_tensor(text, device=device),
                     "input_lens": torch.as_tensor(in_lens, dtype=torch.int32, device=device),
                     "mel": mel, "mel_lens": ml, "pitch": pitch,
                     "energy": torch.linalg.vector_norm(mel, dim=2)})
        audio_s.append(float(mel_lens.sum()) * hop / sr)
    return pool, audio_s


def _device_profile(device):
    """A ``torch.profiler`` profile of the card's records alone, not yet
    entered; the first profile in a process starts the tracer, which takes
    seconds, so one is made and closed here first."""
    from .serve import _sync

    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        torch.ones(1, device=device).add_(1)
    _sync(device)
    return torch.profiler.profile(activities=acts)


class FastPitchTrain:
    def __init__(self, cell: dict, config: dict, mix: dict, device: torch.device, seed: int,
                 root):
        self.cell, self.cfg, self.mix = cell, config, mix
        self.device, self.seed, self.root = device, int(seed), root
        self.extras: dict = {}

    def setup(self):
        from neuraltexttospeech_torch.cli.fastpitch_train import make_loss_fn
        from neuraltexttospeech_torch.models.fastpitch import FastPitch, FastPitchConfig
        from neuraltexttospeech_torch.models.fastpitch_loss import FastPitchLossConfig
        from neuraltexttospeech_torch.train.harness import Trainer, TrainerConfig
        from neuraltexttospeech_torch.train.state import OptimizerConfig

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.pool, self.audio_s = make_pool(self.cfg, self.mix, self.seed, self.device, self.root)
        with torch.device(self.device):
            model = FastPitch(FastPitchConfig(**self.cfg["fastpitch"]))
        self.leaves = [("fastpitch." + n, s) for n, s in weights.spec(model)]
        w = init_weights(self.cfg, self.leaves, self.seed, self.device)
        weights.load(model, {n[len("fastpitch."):]: v for n, v in w.items()})
        del w
        self.trainer = Trainer(
            make_loss_fn(FastPitchLossConfig(**self.mix["loss"]), n_speakers=1), model,
            TrainerConfig(optimizer=OptimizerConfig(**self.mix["optimizer"]), seed=self.seed),
            self.device, dtype=DTYPES[self.cfg["precision"]])
        self.readings, self.recorded = self._first_steps(model)
        for batch in self.pool[len(self.readings["losses"]):]:
            self.trainer.train_step(batch)
        self.next = len(self.pool) - 1

    def _first_steps(self, model):
        """The checked micro-steps, recorded around the program's own calls."""
        from neuraltexttospeech_torch.models import fastpitch
        from neuraltexttospeech_torch.nn import layers, transformer

        ref = train_reference(self.root, self.cell["config"])
        rec = {"masks": [], "mas_in": [], "paths": []}

        def recording(drop):
            def dropout(x, p, generator=None, **kwargs):
                if generator is not None and 0.0 < p < 1.0:
                    copy = torch.Generator(device=generator.device)
                    copy.set_state(generator.get_state())
                    rec["masks"][-1].append(  # on the host, out of the window's memory
                        (torch.rand(tuple(x.shape), generator=copy, device=x.device)
                         < 1.0 - p).cpu())
                return drop(x, p, generator, **kwargs)
            return dropout

        mas = fastpitch.maximum_path

        def recording_mas(log_attn, in_lens, out_lens, *args, **kwargs):
            path = mas(log_attn, in_lens, out_lens, *args, **kwargs)
            rec["mas_in"].append(log_attn.detach().cpu())
            rec["paths"].append(path.cpu())
            return path

        patched = [(layers, "dropout", layers.dropout), (transformer, "dropout",
                   transformer.dropout), (fastpitch, "maximum_path", mas)]
        for owner, name, orig in patched:
            setattr(owner, name, recording_mas if name == "maximum_path" else recording(orig))
        params = dict(model.named_parameters())
        start = {k: p.detach().clone() for k, p in params.items()}
        opt = self.trainer.optimizer
        losses, grad = [], None
        try:
            for i, batch in enumerate(self.pool[:int(self.mix["checked_micro_steps"])]):
                rec["masks"].append([])
                m = self.trainer.train_step(batch)
                losses.append([float(m[t]) for t in ref.TERMS])
                if i + 1 == opt.config.grad_accum_steps:  # the first update is due
                    b1 = opt.config.beta1
                    grad = {"fastpitch." + k: mu / (1.0 - b1) for k, mu in zip(params, opt.mu)}
        finally:
            for owner, name, orig in patched:
                setattr(owner, name, orig)
        update = {"fastpitch." + k: p.detach() - start[k] for k, p in params.items()}
        return {"losses": losses, "grad": leaf_norms(grad), "update": leaf_norms(update),
                # on the host, out of the window's memory
                "grad_at": {k: g.cpu() for k, g in grad.items()},
                "update_at": {k: u.cpu() for k, u in update.items()}}, rec

    def window(self, seconds: float, profile_units: int = 0):
        from .serve import _Profiler, _sync

        prof = _Profiler(self.device) if profile_units else None
        whole = (_device_profile(self.device)
                 if not profile_units and self.device.type == "cuda" else None)
        n_pool = len(self.pool)
        metrics, issue, done = [], [], []
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        _sync(self.device)
        if prof is not None:
            prof.start()
        if whole is not None:
            whole.__enter__()
        t0 = time.perf_counter()
        k = 0
        while time.perf_counter() - t0 < seconds:
            self.next = (self.next + 1) % n_pool
            t = time.perf_counter()
            metrics.append(self.trainer.train_step(self.pool[self.next]))
            issue.append(time.perf_counter() - t)
            done.append(self.next)
            k += 1
            if prof is not None and k == profile_units:
                prof.stop()
        _sync(self.device)
        t_close = time.perf_counter()
        busy = None if self.device.type == "cuda" else t_close - t0  # the CPU is its own device
        if whole is not None:
            from ..yardstick.breakdown import read

            whole.__exit__(None, None, None)
            busy = read(whole, t_close - t0).busy_s
        if prof is not None and prof.running:
            prof.stop()
        finite = (torch.stack([torch.isfinite(m["loss"]) for m in metrics]).cpu().numpy()
                  if metrics else np.zeros(0, bool))
        self.extras.update(
            window_s=t_close - t0, device_busy_s=busy, audio_s=self.audio_s,
            attempted=k, failed=int((~finite).sum()),
            done=[i for i, ok in zip(done, finite) if ok], issue_s=issue,
            shapes=[(tuple(b["mel"].shape[:2]) + (b["text"].shape[1],),
                     b["mel_lens"].tolist()) for b in self.pool],
            traced=done[:profile_units],
            peak_bytes=(torch.cuda.max_memory_allocated(self.device)
                        if self.device.type == "cuda" else 0),
            trace=prof.trace() if prof else None, trace_units=min(profile_units, k))
        return self.extras

    def end_to_end(self) -> dict:
        audio = sum(self.audio_s[i] for i in self.extras["done"])
        return {"train_audio_s_per_device_s": audio / self.extras["device_busy_s"]}

    def free(self):
        self.trainer = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, limits: dict):
        """The reference follows the checked micro-steps from the same
        weights, with the program's dropout masks and MAS paths."""
        batches = self.pool[:len(self.readings["losses"])]
        self.pool = None
        self.free()
        ref = train_reference(self.root, self.cell["config"])
        nets = reference_nets(ref, self.cfg, self.seed, self.device, init_weights, self.leaves)
        try:
            refr = ref.first_steps(self.cfg, self.mix, nets, batches, Arith("f32"),
                                   self.recorded)
        except ref.Misfit as exc:
            print(f"the program's records do not fit its batches: {exc}", file=sys.stderr)
            return verdict({k: float("inf") for k in limits}, limits)
        print(f"first micro-step's terms {list(ref.TERMS)}, program and reference: "
              f"{self.readings['losses'][0]} {refr['losses'][0]}", file=sys.stderr)
        print(f"worst leaves: {worst_leaves(self.readings, refr)}", file=sys.stderr)
        return verdict(fastpitch_training_numbers({**self.readings, **self.recorded}, refr,
                                                  ref.mas, ref.TERMS), limits)


def control(cell, seed: int, device):
    """The control of the FastPitch training cells, for ``calibrate.py``:
    the reference's checked micro-steps with the operands of every product
    rounded one precision below the configuration's (bf16 → fp8 e4m3), its
    own dropout masks drawn from the seed and its own MAS paths, judged as
    the program is against the f32 reference that follows them. Returns
    ``(numbers, {"leaves": the worst leaves})``."""
    cfg, mix = cell.config, cell.mix
    ref = train_reference(cell.root, cell.cell["config"])
    batches = make_pool(cfg, mix, seed, device, cell.root)[0][:int(mix["checked_micro_steps"])]
    generator = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    low = ref.first_steps(cfg, mix, reference_nets(ref, cfg, seed, device, init_weights), batches,
                          Arith("fp8" if cfg["precision"] == "bf16" else "tf32"),
                          generator=generator)
    f32 = ref.first_steps(cfg, mix, reference_nets(ref, cfg, seed, device, init_weights), batches,
                          Arith("f32"), recorded=low)
    return (fastpitch_training_numbers(low, f32, ref.mas, ref.TERMS),
            {"leaves": worst_leaves(low, f32)})


Driver = FastPitchTrain
