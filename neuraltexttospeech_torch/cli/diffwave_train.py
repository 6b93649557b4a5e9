"""DiffWave training CLI.

Port of ``diffwave/train.py``: random ``--crop-mel-frames`` crops of the
wavs (``data/mel_dataset.py::VocoderDataset``, whose mels are computed on
the training device: kernel B1 on the card, twice a batch) → the L1
noise-prediction loss of ``models/diffwave.py`` → the generic
:class:`~..train.harness.Trainer` with Adam (b1 0.9, b2 0.999, eps 1e-8)
and optional global-norm clipping. f32 with TF32 off for cuBLAS and cuDNN,
or with ``--amp`` in bf16 (f32 parameters, gradients and Adam state, as the
JAX CLI's ``--amp``). With ``--validation-files`` each epoch ends with the
validation loss over unshuffled batches, the last short one kept.

Checkpoints go to ``<output>/checkpoints/<step>/``: the train state
(``train_state.pt``: step, model, Adam moments, the data order's position
and crop RNG) and the model as a serving checkpoint (``model.pt`` +
``model_config.json``) that ``cli/diffwave_infer.py --checkpoint`` loads.
``--resume`` continues from the newest one at the saved epoch and batch.

Usage:
  python -m neuraltexttospeech_torch.cli.diffwave_train -o out/diffwave \\
      --training-files filelists/ljs_audio_text_train.txt --epochs 100 [--device cpu]
"""

from __future__ import annotations

import argparse
import pathlib

import torch

from ..data.mel_dataset import VocoderDataset
from ..models.diffwave import DiffWave, DiffWaveConfig, diffwave_loss
from ..models.registry import save_model_config
from ..parallel.distributed import launch
from ..train.harness import Trainer, TrainerConfig
from ..train.state import OptimizerConfig


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--training-files", required=True)
    p.add_argument("--validation-files", default=None)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("-lr", "--learning-rate", type=float, default=2e-4)
    p.add_argument("--max-grad-norm", type=float, default=None)
    p.add_argument("--crop-mel-frames", type=int, default=62)
    p.add_argument("--residual-layers", type=int, default=30)
    p.add_argument("--residual-channels", type=int, default=64)
    p.add_argument("--unconditional", action="store_true")
    p.add_argument("--amp", action="store_true",
                   help="bf16 compute (parameters and optimizer state stay f32)")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--checkpoint-every-steps", type=int, default=1000)
    p.add_argument("--epochs-per-checkpoint", type=int, default=1)
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --output")
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain twins)")
    return p.parse_args(argv)


def make_loss_fn(unconditional: bool):
    """``loss_fn(model, batch, generator)`` of the trainer: the batch's
    audio crops [B, S, 1] and mels, the steps and noise from the generator
    (or from the batch's ``t`` and ``noise`` when it brings them)."""

    def loss_fn(model, batch, generator):
        b = {"audio": batch["audio"][..., 0],
             "mel": None if unconditional else batch["mel"]}
        return diffwave_loss(model, b, generator, t=batch.get("t"), noise=batch.get("noise"))

    return loss_fn


def main(argv=None):
    """Train; returns ``{"trainer", "metrics" (the last epoch's means, as
    floats), "val" (the last validation means), "steps" (run by this call),
    "seconds"}``."""
    args = parse_args(argv)
    device, mesh = launch(args.device, args.batch_size)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    config = DiffWaveConfig(
        crop_mel_frames=args.crop_mel_frames, residual_layers=args.residual_layers,
        residual_channels=args.residual_channels, unconditional=args.unconditional,
        learning_rate=args.learning_rate, max_grad_norm=args.max_grad_norm)
    out = pathlib.Path(args.output)
    save_model_config(out, "DiffWave", config)
    segment = config.crop_mel_frames * config.hop_length
    ds_kw = dict(segment_size=segment, hop_size=config.hop_length, num_mels=config.n_mels,
                 sampling_rate=config.sample_rate, device=device)
    ds = VocoderDataset(args.training_files, seed=args.seed, **ds_kw)
    val_ds = (VocoderDataset(args.validation_files, seed=args.seed + 1, **ds_kw)
              if args.validation_files else None)

    torch.manual_seed(args.seed)
    model = DiffWave(config)
    loss_fn = make_loss_fn(config.unconditional)
    opt_cfg = OptimizerConfig(learning_rate=args.learning_rate,
                              grad_clip_norm=args.max_grad_norm,
                              beta1=0.9, beta2=0.999, eps=1e-8)
    trainer = Trainer(
        loss_fn, model,
        TrainerConfig(optimizer=opt_cfg, seed=args.seed,
                      checkpoint_dir=str(out / "checkpoints"),
                      checkpoint_every=args.checkpoint_every_steps),
        device, serving=lambda: ("DiffWave", config, model.state_dict(), None),
        dtype=torch.bfloat16 if args.amp else None, mesh=mesh)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"DiffWave: {n_params / 1e6:.2f}M params, {len(ds)} clips, "
          f"{'bf16' if args.amp else 'f32'}, device {device}, dp={mesh.n_data if mesh else 1}")

    def batches(epoch, skip):
        return ds.batches(args.batch_size, seed=args.seed + epoch,
                          max_batches=args.steps_per_epoch, skip=skip)

    def val_batches():
        return val_ds.batches(args.batch_size, shuffle=False, drop_last=False)

    return {"trainer": trainer, **trainer.fit(
        batches, args.epochs, resume=args.resume,
        epochs_per_checkpoint=args.epochs_per_checkpoint,
        val_batches=None if val_ds is None else val_batches, data_rng=ds.rng)}


if __name__ == "__main__":
    main()
