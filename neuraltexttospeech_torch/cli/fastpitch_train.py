"""FastPitch training CLI.

Port of ``fastpitch/train.py``: the prepared features (``fastpitch_prepare_dataset``)
→ bucketed batches → the training forward (aligner, MAS on the card through
its CUDA kernel) and ``fastpitch_loss`` → the generic
:class:`~..train.harness.Trainer` with the optimizer of ``--optimizer``
(clipping, accumulation, the noam schedule). f32 with TF32 off for cuBLAS
and cuDNN, or with ``--amp`` in bf16 (f32 parameters, gradients and
optimizer state; the aligner's distances, MAS and the loss targets in f32,
as the JAX CLI's ``--amp``). By default the attention prior is computed on the device from the
lengths; ``--host-prior`` ships the scipy prior with each batch.

Checkpoints go to ``<output>/checkpoints/<step>/``: the train state
(``train_state.pt``: step, model, optimizer moments and accumulator, the
data order's position) and the model as a serving checkpoint (``model.pt`` +
``model_config.json`` with the text front-end) that ``cli/fastpitch_infer.py
--checkpoint`` loads. ``--resume`` continues from the newest one exactly
where it stopped.

Usage:
  python -m neuraltexttospeech_torch.cli.fastpitch_train -o out/fastpitch -d out/feats \\
      --training-files filelists/ljs_audio_text_train.txt --epochs 100 -bs 16 [--device cpu]
"""

from __future__ import annotations

import argparse
import pathlib
import time

import torch

from ..data.dataset import FastPitchDataset
from ..models.fastpitch import FastPitch, FastPitchConfig
from ..models.fastpitch_loss import FastPitchLossConfig, fastpitch_loss
from ..models.registry import save_model_config
from ..ops.prior import beta_binomial_prior
from ..parallel.distributed import launch
from ..train.harness import Trainer, TrainerConfig
from ..train.state import OptimizerConfig


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    io = p.add_argument_group("io")
    io.add_argument("-o", "--output", required=True)
    io.add_argument("-d", "--dataset-path", required=True)
    io.add_argument("--training-files", required=True)
    io.add_argument("--validation-files", default=None)
    io.add_argument("--log-file", default=None, help="accepted and unused, as in the JAX CLI")

    tr = p.add_argument_group("training")
    tr.add_argument("--epochs", type=int, default=100)
    tr.add_argument("-lr", "--learning-rate", type=float, default=1e-4)
    tr.add_argument("-bs", "--batch-size", type=int, default=16)
    tr.add_argument("--optimizer", default="adam", choices=["adam", "adamw", "lamb"])
    tr.add_argument("--grad-clip-thresh", type=float, default=1000.0)
    tr.add_argument("--gradient-accumulation-steps", type=int, default=1)
    tr.add_argument("--warmup-steps", type=int, default=1000)
    tr.add_argument("--seed", type=int, default=1234)
    tr.add_argument("--epochs-per-checkpoint", type=int, default=1)
    tr.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in --output")
    tr.add_argument("--amp", action="store_true",
                    help="bf16 compute (parameters and optimizer state stay f32)")
    tr.add_argument("--steps-per-epoch", type=int, default=None,
                    help="cap batches per epoch (smoke runs)")
    tr.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain twins)")

    ds = p.add_argument_group("dataset")
    ds.add_argument("--host-prior", action="store_true",
                    help="ship the scipy beta-binomial priors with each batch instead of "
                         "computing them on the device from the lengths")
    ds.add_argument("--text-cleaners", nargs="*", default=["english_cleaners_v2"])
    ds.add_argument("--symbol-set", default="english_basic")
    ds.add_argument("--p-arpabet", type=float, default=1.0)
    ds.add_argument("--n-speakers", type=int, default=1)

    m = p.add_argument_group("model (reference arg_parser.py defaults)")
    m.add_argument("--n-mel-channels", type=int, default=80)
    m.add_argument("--n-symbols", type=int, default=148)
    m.add_argument("--symbols-embedding-dim", type=int, default=384)
    m.add_argument("--in-fft-n-layers", type=int, default=6)
    m.add_argument("--out-fft-n-layers", type=int, default=6)
    m.add_argument("--energy-conditioning", action="store_true", default=True)
    m.add_argument("--no-energy-conditioning", dest="energy_conditioning",
                   action="store_false")

    loss = p.add_argument_group("loss scales")
    loss.add_argument("--dur-predictor-loss-scale", type=float, default=0.1)
    loss.add_argument("--pitch-predictor-loss-scale", type=float, default=0.1)
    loss.add_argument("--attn-loss-scale", type=float, default=1.0)
    return p.parse_args(argv)


def make_loss_fn(loss_cfg: FastPitchLossConfig, n_speakers: int):
    """``loss_fn(model, batch, generator)`` of the trainer: the training
    forward on the batch, its prior from the batch or from the lengths."""

    def loss_fn(model, batch, generator):
        prior = batch.get("attn_prior")
        if prior is None:
            prior = beta_binomial_prior(batch["mel_lens"], batch["input_lens"],
                                        batch["mel"].shape[1], batch["text"].shape[1])
        out = model(batch["text"], batch["input_lens"], batch["mel"], batch["mel_lens"],
                    batch["pitch"], batch["energy"],
                    batch["speaker"] if n_speakers > 1 else None, prior,
                    generator=generator)
        return fastpitch_loss(out, batch["mel"], batch["input_lens"], batch["mel_lens"],
                              loss_cfg)

    return loss_fn


def main(argv=None):
    """Train; returns ``{"trainer", "metrics" (the last epoch's means, as
    floats), "steps" (run by this call), "seconds"}``."""
    args = parse_args(argv)
    device, mesh = launch(args.device, args.batch_size)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    ds_kw = dict(text_cleaners=args.text_cleaners, symbol_set=args.symbol_set,
                 p_arpabet=args.p_arpabet, n_speakers=args.n_speakers,
                 with_prior=args.host_prior, device=device)
    config = FastPitchConfig(
        n_mel_channels=args.n_mel_channels, n_symbols=args.n_symbols,
        symbols_embedding_dim=args.symbols_embedding_dim,
        in_fft_n_layers=args.in_fft_n_layers, out_fft_n_layers=args.out_fft_n_layers,
        energy_conditioning=args.energy_conditioning, n_speakers=args.n_speakers)
    train_ds = FastPitchDataset(args.dataset_path, args.training_files,
                                n_mel_channels=config.n_mel_channels, **ds_kw)
    val_ds = (FastPitchDataset(args.dataset_path, args.validation_files,
                               n_mel_channels=config.n_mel_channels, **ds_kw)
              if args.validation_files else None)
    out = pathlib.Path(args.output)
    frontend = {"text_cleaners": list(args.text_cleaners), "symbol_set": args.symbol_set,
                "p_arpabet": args.p_arpabet}
    save_model_config(out, "FastPitch", config, frontend=frontend)

    torch.manual_seed(args.seed)
    model = FastPitch(config)
    loss_fn = make_loss_fn(FastPitchLossConfig(
        dur_predictor_loss_scale=args.dur_predictor_loss_scale,
        pitch_predictor_loss_scale=args.pitch_predictor_loss_scale,
        attn_loss_scale=args.attn_loss_scale), args.n_speakers)
    opt_cfg = OptimizerConfig(
        optimizer=args.optimizer, learning_rate=args.learning_rate,
        grad_clip_norm=args.grad_clip_thresh,
        grad_accum_steps=args.gradient_accumulation_steps,
        schedule="noam", warmup_steps=args.warmup_steps)
    trainer = Trainer(
        loss_fn, model,
        TrainerConfig(optimizer=opt_cfg, seed=args.seed,
                      checkpoint_dir=str(out / "checkpoints")),
        device, serving=lambda: ("FastPitch", config, model.state_dict(), frontend),
        dtype=torch.bfloat16 if args.amp else None, mesh=mesh)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"FastPitch: {n_params / 1e6:.1f}M params, {len(train_ds)} train items, "
          f"{'bf16' if args.amp else 'f32'}, device {device}, dp={mesh.n_data if mesh else 1}")

    position = (0, 0)  # (epoch, batches done in it)
    if args.resume:
        state = trainer.resume()
        if state is not None:
            position = tuple(state["position"])
            print(f"resumed at step {trainer.step}")

    metrics, steps, t_start = {}, 0, time.perf_counter()
    start_epoch, skip = position
    for epoch in range(start_epoch, args.epochs):
        skip_now = skip if epoch == start_epoch else 0

        def produce(epoch=epoch, skip_now=skip_now):
            for k, b in enumerate(train_ds.batches(args.batch_size, seed=args.seed + epoch,
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
    return {"trainer": trainer, "metrics": metrics, "steps": steps,
            "seconds": time.perf_counter() - t_start}


if __name__ == "__main__":
    main()
