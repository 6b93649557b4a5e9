"""Flowtron training CLI.

Port of ``flowtron/train.py``: the cached log-mels of
``tacotron2_prepare_dataset`` (the same features; a wav without one is
computed on the training device: B1 on the card) → ``FastPitchDataset``
(``english_cleaners``, no ARPAbet, no pitch or prior; bucketed by length,
the order from ``--seed`` + epoch) → the density pass and
:func:`~..models.flowtron.flowtron_loss` with the stop-gate targets ``pos ≥
len − 1`` → the generic :class:`~..train.harness.Trainer` with Adam
(lr ``-lr``, β2 0.999, eps 1e-8, global-norm clip at 1.0). Each step's
dropout stream comes from ``(seed, step)``.

``-c`` reads the ``model_config`` keys of a JSON (``Flowtron_TF/config.json``);
``--amp`` computes in bf16 (``FlowtronConfig.dtype``: the LSTM cells, the
speaker embedding and the instance norms' outputs stay f32, as in JAX), f32
otherwise with TF32 off. ``--validation-files`` adds a validation pass each
epoch. Checkpoints go to ``<output>/checkpoints/<step>/`` at the end of every
``--epochs-per-checkpoint`` epochs: ``train_state.pt`` (model, Adam's
moments, the data order's position) and a serving ``model.pt`` +
``model_config.json`` (``"Flowtron"``) that ``flowtron_infer --checkpoint``
loads. ``--resume`` continues from the newest at the saved epoch and batch.

Usage:
  python -m neuraltexttospeech_torch.cli.flowtron_train -o out/flowtron -d out/feats \\
      --training-files filelists/ljs_audio_text_train.txt --epochs 1000 [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time

import torch

from ..data.dataset import FastPitchDataset
from ..models.flowtron import Flowtron, FlowtronConfig, flowtron_loss
from ..models.registry import save_model_config
from ..models.tacotron2_train import gate_targets
from ..parallel.distributed import launch
from ..train.harness import Trainer, TrainerConfig
from ..train.state import OptimizerConfig


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-c", "--config", default=None,
                   help="JSON config with model_config keys (Flowtron_TF/config.json)")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-d", "--dataset-path", required=True)
    p.add_argument("--training-files", required=True)
    p.add_argument("--validation-files", default=None)
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("-lr", "--learning-rate", type=float, default=1e-4)
    p.add_argument("-bs", "--batch-size", type=int, default=6)
    p.add_argument("--sigma", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--amp", action="store_true", help="bfloat16 compute")
    p.add_argument("--epochs-per-checkpoint", type=int, default=1)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain paths)")
    return p.parse_args(argv)


def read_config(path, amp: bool = False) -> FlowtronConfig:
    """``FlowtronConfig`` from a JSON's ``model_config`` keys (the others and
    ``dtype`` ignored), bf16 with ``amp``."""
    raw = json.loads(pathlib.Path(path).read_text()).get("model_config", {}) if path else {}
    fields = {f.name for f in dataclasses.fields(FlowtronConfig)} - {"dtype"}
    return FlowtronConfig(**{k: v for k, v in raw.items() if k in fields},
                          dtype=torch.bfloat16 if amp else None)


def make_loss_fn(sigma: float = 1.0):
    """``loss_fn(model, batch, generator)`` of the trainer: the density pass
    on the batch and :func:`flowtron_loss` with the stop-gate targets."""

    def loss_fn(model, batch, generator):
        out = model(batch["mel"], batch["speaker"], batch["text"], batch["input_lens"],
                    batch["mel_lens"], generator)
        return flowtron_loss(out, batch["mel_lens"],
                             gate_targets(batch["mel_lens"], batch["mel"].shape[1]), sigma=sigma)

    return loss_fn


def main(argv=None):
    """Train; returns ``{"trainer", "config", "metrics" (the last epoch's
    means), "val" (the last validation means), "steps" (run by this call),
    "seconds"}``."""
    args = parse_args(argv)
    device, mesh = launch(args.device, args.batch_size)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = pathlib.Path(args.output)

    config = read_config(args.config, args.amp)
    save_model_config(out, "Flowtron", config)
    ds_kw = dict(text_cleaners=["english_cleaners"], p_arpabet=0.0, with_pitch=False,
                 with_prior=False, n_speakers=config.n_speakers, device=device)
    ds = FastPitchDataset(args.dataset_path, args.training_files, **ds_kw)
    val_ds = (FastPitchDataset(args.dataset_path, args.validation_files, **ds_kw)
              if args.validation_files else None)
    torch.manual_seed(args.seed)
    model = Flowtron(config)
    loss_fn = make_loss_fn(args.sigma)
    opt_cfg = OptimizerConfig(learning_rate=args.learning_rate, grad_clip_norm=1.0, beta2=0.999,
                              eps=1e-8)
    trainer = Trainer(loss_fn, model,
                      TrainerConfig(optimizer=opt_cfg, seed=args.seed,
                                    checkpoint_dir=str(out / "checkpoints")),
                      device, serving=lambda: ("Flowtron", config, model.state_dict(), None),
                      mesh=mesh)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"Flowtron: {n_params / 1e6:.1f}M params, {len(ds)} items, "
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
                                             max_batches=args.steps_per_epoch, skip=skip_now)):
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
            print(f"epoch {epoch} val: " + " ".join(f"{k}={v:.4f}" for k, v in sorted(val.items())))
        trainer.extra_state["position"] = (epoch + 1, 0)
        if (epoch + 1) % max(args.epochs_per_checkpoint, 1) == 0:
            trainer.save()
    trainer.save()
    print("done")
    return {"trainer": trainer, "config": config, "metrics": metrics, "val": val,
            "steps": steps, "seconds": time.perf_counter() - t_start}


if __name__ == "__main__":
    main()
