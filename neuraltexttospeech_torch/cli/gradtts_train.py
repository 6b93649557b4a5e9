"""Grad-TTS training CLI.

Port of ``gradtts/train.py``: the FastPitch dataset's mels (no pitch, no
prior; ``fastpitch_prepare_dataset`` writes them, or the first access does,
through kernel B1 on the card) → bucketed batches whose text is
interspersed with the blank id 148 and padded to a multiple of 16 tokens
(:func:`prep_batch`) → ``GradTTS.compute_loss`` (MAS on the card through
its CUDA kernel, the random ``--out-size`` segment, the score loss) → the
generic :class:`~..train.harness.Trainer` with Adam (lr 1e-4, b2
0.999, eps 1e-8, global-norm clip 1.0). f32 with TF32 off for cuBLAS and
cuDNN, or with ``--amp`` in bf16 (f32 parameters, gradients and Adam state;
the log-prior, MAS and the losses' targets in f32, as the JAX CLI's
``--amp``). With ``--validation-files`` each epoch ends with the validation
losses over unshuffled batches, the last short one kept.

Checkpoints go to ``<output>/checkpoints/<step>/``: the train state
(``train_state.pt``: step, model, Adam moments, the data order's position)
and the model as a serving checkpoint (``model.pt`` +
``model_config.json``) that ``cli/gradtts_infer.py --checkpoint`` loads.
``--resume`` continues from the newest one at the saved epoch and batch.

Usage:
  python -m neuraltexttospeech_torch.cli.gradtts_train -o out/gradtts -d out/feats \\
      --training-files filelists/ljs_audio_text_train.txt --epochs 10000 [--device cpu]
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np
import torch

from ..data.dataset import FastPitchDataset
from ..models.gradtts import GradTTS, GradTTSConfig
from ..models.registry import save_model_config
from ..parallel.distributed import launch
from ..text.processing import intersperse
from ..train.harness import Trainer, TrainerConfig
from ..train.state import OptimizerConfig

N_BASE_SYMBOLS = 148  # len(symbols); the blank's id when --no-blank is not given


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-d", "--dataset-path", required=True)
    p.add_argument("--training-files", required=True)
    p.add_argument("--validation-files", default=None)
    p.add_argument("--epochs", type=int, default=10000)
    p.add_argument("-lr", "--learning-rate", type=float, default=1e-4)
    p.add_argument("-bs", "--batch-size", type=int, default=16)
    p.add_argument("--seed", type=int, default=37)
    p.add_argument("--out-size", type=int, default=172)
    p.add_argument("--n-enc-layers", type=int, default=6)
    p.add_argument("--n-enc-channels", type=int, default=192)
    p.add_argument("--dec-dim", type=int, default=64)
    p.add_argument("--no-blank", dest="add_blank", action="store_false")
    p.add_argument("--amp", action="store_true",
                   help="bf16 compute (parameters and optimizer state stay f32)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --output")
    p.add_argument("--epochs-per-checkpoint", type=int, default=1)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain twins)")
    return p.parse_args(argv)


def prep_batch(batch):
    """The batch with each text interspersed with the blank id 148 and padded
    to a multiple of 16 tokens (reference ``Grad-TTS_TF/utils.py:9-13``)."""
    texts = [intersperse(list(row[:n]), N_BASE_SYMBOLS)
             for row, n in zip(batch["text"], batch["input_lens"])]
    T = (max(len(t) for t in texts) + 15) // 16 * 16
    text = np.zeros((len(texts), T), np.int32)
    for i, t in enumerate(texts):
        text[i, :len(t)] = t
    return {**batch, "text": text, "input_lens": np.asarray([len(t) for t in texts], np.int32)}


def make_loss_fn(out_size: int):
    """``loss_fn(model, batch, generator)`` of the trainer: the three losses
    and their sum; the cut's ``u``, the time ``t`` and the noise ``z`` come
    from the generator, or from the batch when it brings them."""

    def loss_fn(model, batch, generator):
        dur, prior, diff = model.compute_loss(
            batch["text"], batch["input_lens"], batch["mel"], batch["mel_lens"],
            out_size=out_size, generator=generator, u=batch.get("u"), t=batch.get("t"),
            z=batch.get("z"))
        return dur + prior + diff, {"dur_loss": dur, "prior_loss": prior, "diff_loss": diff}

    return loss_fn


def main(argv=None):
    """Train; returns ``{"trainer", "metrics" (the last epoch's means, as
    floats), "val" (the last validation means), "steps" (run by this call),
    "seconds"}``."""
    args = parse_args(argv)
    device, mesh = launch(args.device, args.batch_size)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    ds_kw = dict(text_cleaners=["english_cleaners"], p_arpabet=0.0, with_pitch=False,
                 with_prior=False, device=device)
    ds = FastPitchDataset(args.dataset_path, args.training_files, **ds_kw)
    val_ds = (FastPitchDataset(args.dataset_path, args.validation_files, **ds_kw)
              if args.validation_files else None)
    config = GradTTSConfig(
        n_symbols=N_BASE_SYMBOLS + (1 if args.add_blank else 0), out_size=args.out_size,
        learning_rate=args.learning_rate, n_enc_layers=args.n_enc_layers,
        n_enc_channels=args.n_enc_channels, dec_dim=args.dec_dim)
    out = pathlib.Path(args.output)
    save_model_config(out, "GradTTS", config)

    def prep(batch):
        return prep_batch(batch) if args.add_blank else batch

    torch.manual_seed(args.seed)
    model = GradTTS(config)
    loss_fn = make_loss_fn(args.out_size)
    opt_cfg = OptimizerConfig(learning_rate=args.learning_rate, grad_clip_norm=1.0,
                              beta2=0.999, eps=1e-8)
    trainer = Trainer(
        loss_fn, model,
        TrainerConfig(optimizer=opt_cfg, seed=args.seed,
                      checkpoint_dir=str(out / "checkpoints")),
        device, serving=lambda: ("GradTTS", config, model.state_dict(), None),
        dtype=torch.bfloat16 if args.amp else None, mesh=mesh)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"GradTTS: {n_params / 1e6:.1f}M params, {len(ds)} items, "
          f"{'bf16' if args.amp else 'f32'}, device {device}, dp={mesh.n_data if mesh else 1}")

    def batches(epoch, skip):
        return map(prep, ds.batches(args.batch_size, seed=args.seed + epoch,
                                    max_batches=args.steps_per_epoch, skip=skip))

    def val_batches():
        return map(prep, val_ds.batches(args.batch_size, shuffle=False, drop_last=False))

    return {"trainer": trainer, **trainer.fit(
        batches, args.epochs, resume=args.resume,
        epochs_per_checkpoint=args.epochs_per_checkpoint,
        val_batches=None if val_ds is None else val_batches)}


if __name__ == "__main__":
    main()
