"""Tacotron 2 training CLI.

Port of ``tacotron2/train.py``: the cached log-mels of
``tacotron2_prepare_dataset`` (a wav without one is computed on the training
device: B1 on the card) → ``FastPitchDataset.batches`` (bucketed by length,
the order from ``--seed`` + epoch) → the generic
:class:`~..train.harness.Trainer` with ``models/tacotron2_train.py``'s loss
and AdamW (weight decay 1e-6 on every parameter, global-norm clip at 1.0).
Each step's dropout stream comes from ``(seed, step)``; the BatchNorms take
the batch's statistics and update their buffers in the step's forward.

f32 with TF32 off for cuBLAS and cuDNN, or with ``--amp`` in bf16
(``Tacotron2Config.dtype``; the embedding, the encoder's BiLSTM and the
decoder's carry stay f32, as in JAX). ``--override key=value`` changes any
config field; ``--validation-files`` is parsed and not read, as in the JAX
CLI. Checkpoints go to ``<output>/checkpoints/<step>/`` every
``--iters-per-checkpoint`` steps and at the end of every
``--epochs-per-checkpoint`` epochs: ``train_state.pt`` (the model with its
BatchNorm buffers, AdamW's moments and the data order's position) and a
serving ``model.pt`` + ``model_config.json`` (``"Tacotron2"``) that
``tacotron2_infer --checkpoint`` loads. ``--resume`` continues from the
newest at the saved epoch and batch (the JAX CLI restarts the epoch loop).

Usage:
  python -m neuraltexttospeech_torch.cli.tacotron2_train -o out/tacotron2 -d out/feats \\
      --training-files filelists/ljs_audio_text_train.txt --epochs 500 [--device cpu]
"""

from __future__ import annotations

import argparse
import pathlib

import torch

from ..data.dataset import FastPitchDataset
from ..models.registry import apply_overrides, save_model_config
from ..models.tacotron2 import Tacotron2, Tacotron2Config
from ..models.tacotron2_train import loss_fn, optimizer_config
from ..parallel.distributed import launch
from ..train.harness import Trainer, TrainerConfig


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-d", "--dataset-path", required=True)
    p.add_argument("--training-files", required=True)
    p.add_argument("--validation-files", default=None)
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("-lr", "--learning-rate", type=float, default=1e-3)
    p.add_argument("-bs", "--batch-size", type=int, default=64)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--iters-per-checkpoint", type=int, default=1000)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--epochs-per-checkpoint", type=int, default=1)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--text-cleaners", nargs="*", default=["english_cleaners"])
    p.add_argument("--n-symbols", type=int, default=148)
    p.add_argument("--override", action="append", default=[],
                   help="config override key=value (repeatable, dotted keys)")
    p.add_argument("--amp", action="store_true", help="bfloat16 compute")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain paths)")
    return p.parse_args(argv)


def main(argv=None):
    """Train; returns ``{"trainer", "config", "metrics" (the last epoch's
    means), "val" (empty: no validation set), "steps" (run by this call),
    "seconds"}``."""
    args = parse_args(argv)
    device, mesh = launch(args.device, args.batch_size)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = pathlib.Path(args.output)

    ds = FastPitchDataset(args.dataset_path, args.training_files,
                          text_cleaners=args.text_cleaners, p_arpabet=0.0, with_pitch=False,
                          with_prior=False, device=device)
    config = apply_overrides(
        Tacotron2Config(n_symbols=args.n_symbols,
                        dtype=torch.bfloat16 if args.amp else None), args.override)
    save_model_config(out, "Tacotron2", config)
    torch.manual_seed(args.seed)
    model = Tacotron2(config)
    trainer = Trainer(
        loss_fn, model,
        TrainerConfig(optimizer=optimizer_config(args.learning_rate), seed=args.seed,
                      log_every=100, checkpoint_dir=str(out / "checkpoints"),
                      checkpoint_every=args.iters_per_checkpoint),
        device, serving=lambda: ("Tacotron2", config, model.state_dict(), None), mesh=mesh)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"Tacotron2: {n_params / 1e6:.1f}M params, {len(ds)} items, "
          f"{'bf16' if args.amp else 'f32'}, device {device}, dp={mesh.n_data if mesh else 1}")

    def batches(epoch, skip):
        return ds.batches(args.batch_size, seed=args.seed + epoch,
                          max_batches=args.steps_per_epoch, skip=skip)

    return {"trainer": trainer, "config": config, **trainer.fit(
        batches, args.epochs, resume=args.resume,
        epochs_per_checkpoint=args.epochs_per_checkpoint)}


if __name__ == "__main__":
    main()
