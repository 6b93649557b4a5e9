"""FastSpeech 2 training CLI over the preprocessed (MFA-aligned) features.

Port of ``fastspeech2/train.py``: :class:`FS2Dataset` reads the prepared
``train.txt`` and per-utterance ``.npy`` files (``fastspeech2_prepare_dataset``),
encoding the phones with the front end recorded in ``frontend.json`` → the
teacher-forced forward and ``fastspeech2_loss`` → the generic
:class:`~..train.harness.Trainer` with Adam on the noam schedule (lr 1e-3,
warm-up 4000, b2 0.98, eps 1e-9, global-norm clip 1.0). The config's bucket
ranges come from ``stats.json``; ``--override key=value`` changes any field.
f32 with TF32 off for cuBLAS and cuDNN, or with ``--amp`` in bf16 (f32
parameters, gradients and Adam state, as the JAX CLI's ``--amp``). With
``--validation-split`` each epoch ends with the losses over that split's
unshuffled batches, the last short one kept.

Checkpoints go to ``<output>/checkpoints/<step>/``: the train state
(``train_state.pt``: step, model, Adam moments, the data order's position)
and the model as a serving checkpoint (``model.pt`` + ``model_config.json``
with the front end) that ``cli/fastspeech2_infer.py --checkpoint`` loads.
``--resume`` continues from the newest one at the saved epoch and batch.

Usage:
  python -m neuraltexttospeech_torch.cli.fastspeech2_train -o out/fs2 \\
      -d preprocessed/LJSpeech --epochs 900 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

import numpy as np
import torch

from ..data.dataset import pad_to, round_up
from ..models.fastspeech2 import FastSpeech2, FastSpeech2Config, fastspeech2_loss
from ..models.registry import apply_overrides, save_model_config
from ..parallel.distributed import launch
from ..text.processing import TextProcessing
from ..train.harness import Trainer, TrainerConfig
from ..train.state import OptimizerConfig


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-d", "--preprocessed-path", required=True)
    p.add_argument("--validation-split", default=None,
                   help="evaluate on <preprocessed>/<split>.txt each epoch")
    p.add_argument("--epochs", type=int, default=900)
    p.add_argument("-lr", "--learning-rate", type=float, default=1e-3)
    p.add_argument("-bs", "--batch-size", type=int, default=16)
    p.add_argument("--warmup-steps", type=int, default=4000)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --output")
    p.add_argument("--amp", action="store_true",
                   help="bf16 compute (parameters and optimizer state stay f32)")
    p.add_argument("--epochs-per-checkpoint", type=int, default=1)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--override", action="append", default=[],
                   help="config override key=value (repeatable, dotted keys)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain twins)")
    return p.parse_args(argv)


class FS2Dataset:
    """The preprocessed ``<split>.txt`` and per-utterance ``.npy`` features
    (JAX ``fastspeech2/train.py::FS2Dataset``): phones encoded with the front
    end of ``frontend.json`` when the directory has one (else english_basic,
    english_cleaners, arpabet on), batches padded to multiples of 8 tokens
    and 32 frames."""

    def __init__(self, preprocessed_path: str, split: str = "train"):
        self.root = pathlib.Path(preprocessed_path)
        fe = {}
        fe_path = self.root / "frontend.json"
        if fe_path.exists():
            fe = json.loads(fe_path.read_text())
        self.frontend = {"symbol_set": fe.get("symbol_set", "english_basic"),
                         "text_cleaners": list(fe.get("text_cleaners", ["english_cleaners"])),
                         "p_arpabet": fe.get("p_arpabet", 1.0)}
        self.tp = TextProcessing(self.frontend["symbol_set"], self.frontend["text_cleaners"],
                                 p_arpabet=self.frontend["p_arpabet"])
        self.entries = []
        for line in (self.root / f"{split}.txt").read_text().splitlines():
            parts = line.split("|")
            if len(parts) >= 2:
                self.entries.append((parts[0], parts[1]))

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        utt, phones = self.entries[i]
        text = np.asarray(self.tp.encode_text(phones), np.int32)
        feats = {k: np.load(self.root / f"{utt}_{k}.npy")
                 for k in ("mel", "duration", "pitch", "energy")}
        n = min(len(text), len(feats["duration"]))
        return {"text": text[:n], "mel": feats["mel"],
                "dur": feats["duration"].astype(np.float32)[:n],
                "pitch": feats["pitch"].astype(np.float32)[:n],
                "energy": feats["energy"].astype(np.float32)[:n]}

    def batches(self, batch_size, *, shuffle=True, seed=0, max_batches=None, drop_last=True,
                skip: int = 0):
        """Padded batches in a seeded shuffled order; ``skip`` leaves out the
        first batches of the order (a resumed epoch)."""
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        stop = len(order) - batch_size + 1 if drop_last else len(order)
        starts = list(range(0, max(stop, 0), batch_size))
        if max_batches is not None:
            starts = starts[:max_batches]
        for s in starts[skip:]:
            items = [self[j] for j in order[s:s + batch_size]]
            T_text = round_up(max(len(it["text"]) for it in items), 8)
            T_mel = round_up(max(it["mel"].shape[0] for it in items), 32)
            yield {"text": np.stack([pad_to(it["text"], T_text) for it in items]),
                   "input_lens": np.asarray([len(it["text"]) for it in items], np.int32),
                   "mel": np.stack([pad_to(it["mel"], T_mel) for it in items]),
                   "mel_lens": np.asarray([it["mel"].shape[0] for it in items], np.int32),
                   **{k: np.stack([pad_to(it[k], T_text) for it in items])
                      for k in ("dur", "pitch", "energy")}}


def loss_fn(model, batch, generator):
    """``loss_fn(model, batch, generator)`` of the trainer: the
    teacher-forced forward and ``fastspeech2_loss``."""
    out = model(batch["text"], batch["input_lens"], mel_max_len=batch["mel"].shape[1],
                dur_tgt=batch["dur"], pitch_tgt=batch["pitch"], energy_tgt=batch["energy"],
                generator=generator)
    return fastspeech2_loss(out, batch["mel"], batch["dur"], batch["pitch"], batch["energy"],
                            batch["input_lens"], batch["mel_lens"])


def main(argv=None):
    """Train; returns ``{"trainer", "metrics" (the last epoch's means, as
    floats), "val" (the last validation means), "steps" (run by this call),
    "seconds"}``."""
    args = parse_args(argv)
    device, mesh = launch(args.device, args.batch_size)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    ds = FS2Dataset(args.preprocessed_path)
    val_ds = (FS2Dataset(args.preprocessed_path, split=args.validation_split)
              if args.validation_split else None)
    stats_path = pathlib.Path(args.preprocessed_path) / "stats.json"
    kw = {}
    if stats_path.exists():
        stats = json.loads(stats_path.read_text())
        kw = {k: stats[k] for k in ("pitch_min", "pitch_max", "energy_min", "energy_max")
              if k in stats}
    config = apply_overrides(FastSpeech2Config(**kw), args.override)
    out = pathlib.Path(args.output)
    save_model_config(out, "FastSpeech2", config, frontend=ds.frontend)

    torch.manual_seed(args.seed)
    model = FastSpeech2(config)
    opt_cfg = OptimizerConfig(learning_rate=args.learning_rate, schedule="noam",
                              warmup_steps=args.warmup_steps, grad_clip_norm=1.0,
                              beta2=0.98, eps=1e-9)
    trainer = Trainer(
        loss_fn, model,
        TrainerConfig(optimizer=opt_cfg, seed=args.seed,
                      checkpoint_dir=str(out / "checkpoints")),
        device, serving=lambda: ("FastSpeech2", config, model.state_dict(), ds.frontend),
        dtype=torch.bfloat16 if args.amp else None, mesh=mesh)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"FastSpeech2: {n_params / 1e6:.1f}M params, {len(ds)} items, "
          f"{'bf16' if args.amp else 'f32'}, device {device}, dp={mesh.n_data if mesh else 1}")

    position = (0, 0)  # (epoch, batches done in it)
    if args.resume:
        state = trainer.resume()
        if state is not None:
            position = tuple(state["position"])
            print(f"resumed at step {trainer.step}")

    metrics, val, steps, t_start = {}, {}, 0, time.perf_counter()
    start_epoch, skip = position
    for epoch in range(start_epoch, args.epochs):
        skip_now = skip if epoch == start_epoch else 0

        def produce(epoch=epoch, skip_now=skip_now):
            for k, b in enumerate(ds.batches(args.batch_size, seed=args.seed + epoch,
                                             max_batches=args.steps_per_epoch,
                                             skip=skip_now)):
                b["position"] = (epoch, skip_now + k + 1)
                yield b

        def on_step(batch):
            trainer.extra_state["position"] = batch["position"]

        trainer.extra_state["position"] = (epoch, skip_now)
        step0 = trainer.step
        metrics = trainer.fit_epoch(trainer.device_iter(produce()), epoch=epoch,
                                    on_step=on_step)
        steps += trainer.step - step0
        print(f"epoch {epoch}: " + " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items())))
        if val_ds is not None:
            val = trainer.evaluate(
                loss_fn, val_ds.batches(args.batch_size, shuffle=False, drop_last=False))
            print(f"epoch {epoch} val: "
                  + " ".join(f"{k}={v:.4f}" for k, v in sorted(val.items())))
        trainer.extra_state["position"] = (epoch + 1, 0)
        if (epoch + 1) % max(args.epochs_per_checkpoint, 1) == 0:
            trainer.save()
    trainer.save()
    print("done")
    return {"trainer": trainer, "metrics": metrics, "val": val, "steps": steps,
            "seconds": time.perf_counter() - t_start}


if __name__ == "__main__":
    main()
