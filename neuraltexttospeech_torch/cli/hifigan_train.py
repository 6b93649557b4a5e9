"""HiFi-GAN GAN training CLI.

Port of ``hifigan/train.py``: a config (v1/v2/v3 or a reference
``config_v*.json``) → ``VocoderDataset`` crops → the 3-optimizer GAN step of
``models/hifigan_gan.py`` on one card (or data parallel under ``torchrun``:
``parallel/distributed.py::launch``), f32 with TF32 off for cuBLAS and
cuDNN, or with ``--amp`` in bf16 (f32 parameters, gradients and Adam
state, as the JAX CLI's ``--amp``). The MSD's grouped convs run through
kernel B2 (its f32 or bf16 form) unless the config's ``fast_grouped_convs``
says ``"stock"``/False; the mels run through kernel B1, in f32. By default a
batch carries only the audio crops and the step computes both mels
(``--host-mels`` computes them on the host instead). With
``--fine-tuning-mel-dir`` the generator's input mels are an acoustic
model's ``<utt>_mel.npy`` files, cropped with the audio aligned to them.

Checkpoints go to ``<output>/checkpoints/<step>/``: the train state
(``train_state.pt``: step, G/MPD/MSD, spectral-norm buffers, the three Adam
states, the data order's position and RNG) and the generator as a serving
checkpoint (``model.pt`` + ``model_config.json``, weight norm folded) that
``cli/hifigan_infer.py --checkpoint`` loads. ``--resume`` continues from
the newest one exactly where it stopped.

Usage:
  python -m neuraltexttospeech_torch.cli.hifigan_train --config v1 -o out/hifigan \\
      --training-files filelists/ljs_audio_text_train.txt --epochs 100 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

import torch

from ..data.mel_dataset import VocoderDataset
from ..models.hifigan import HiFiGANConfig
from ..models.hifigan_gan import HiFiGANTrainer
from ..models.registry import save_model_config
from ..parallel.distributed import launch
from ..train.checkpoint import Checkpointer


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="v1",
                   help="v1|v2|v3 or a path to a JSON config (reference config_v*.json keys)")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--training-files", required=True)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=None, help="override config batch_size")
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--checkpoint-every-steps", type=int, default=1000)
    p.add_argument("--epochs-per-checkpoint", type=int, default=1)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--host-mels", action="store_true",
                   help="compute the input/loss mels on the host in collation instead "
                        "of inside the step")
    p.add_argument("--amp", action="store_true",
                   help="bf16 compute (parameters and optimizer state stay f32)")
    p.add_argument("--fine-tuning-mel-dir", default=None,
                   help="dir of <utt>_mel.npy acoustic-model mels to train on")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain twins)")
    return p.parse_args(argv)


def load_config(spec: str) -> HiFiGANConfig:
    """v1/v2/v3, or a JSON file with the reference's ``config_v*.json`` keys
    (unknown keys are ignored)."""
    if spec in ("v1", "v2", "v3"):
        return getattr(HiFiGANConfig, spec)()
    with open(spec) as f:
        raw = json.load(f)
    keys = {f.name for f in HiFiGANConfig.__dataclass_fields__.values()}
    kw = {k: v for k, v in raw.items() if k in keys and v is not None}
    for tup in ("upsample_rates", "upsample_kernel_sizes", "resblock_kernel_sizes"):
        if tup in kw:
            kw[tup] = tuple(kw[tup])
    if "resblock_dilation_sizes" in kw:
        kw["resblock_dilation_sizes"] = tuple(tuple(d) for d in kw["resblock_dilation_sizes"])
    return HiFiGANConfig(**kw)


def main(argv=None):
    """Train; returns ``{"trainer", "metrics" (last step's, as floats),
    "steps" (run by this call), "seconds"}``."""
    args = parse_args(argv)
    config = load_config(args.config)
    batch_size = args.batch_size or config.batch_size
    device, mesh = launch(args.device, batch_size)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    out = pathlib.Path(args.output)
    save_model_config(out, "HiFiGAN", config)
    ds = VocoderDataset(
        args.training_files, segment_size=config.segment_size, n_fft=config.n_fft,
        hop_size=config.hop_size, win_size=config.win_size, num_mels=config.num_mels,
        sampling_rate=config.sampling_rate, fmin=config.fmin, fmax=config.fmax,
        fmax_for_loss=config.fmax_for_loss, fine_tuning_mel_dir=args.fine_tuning_mel_dir,
        seed=config.seed)
    steps_per_epoch = args.steps_per_epoch or max(len(ds) // batch_size, 1)
    trainer = HiFiGANTrainer(config, device, steps_per_epoch=steps_per_epoch,
                             dtype=torch.bfloat16 if args.amp else None, mesh=mesh)
    n_g = sum(p.numel() for p in trainer.gen.parameters())
    print(f"HiFi-GAN {args.config}: generator {n_g / 1e6:.1f}M params, {len(ds)} clips, "
          f"batch {batch_size}, MSD group impl {trainer.msd_group_impl}, "
          f"{'bf16' if args.amp else 'f32'}, device {device}, "
          f"dp={mesh.n_data if mesh else 1}")

    ckpt = Checkpointer(out / "checkpoints", save_interval_steps=args.checkpoint_every_steps)
    # where the data order stands: (epoch, batches done in it), crop RNG state
    position, data_rng = (0, 0), ds.rng.bit_generator.state
    if args.resume and ckpt.latest_step() is not None:
        state = ckpt.restore()
        trainer.load_state_dict(state["trainer"])
        position, data_rng = tuple(state["position"]), state["data_rng"]
        ds.rng.bit_generator.state = data_rng
        print(f"resumed at step {trainer.step}")

    def save(force: bool):
        ckpt.save(trainer.step, {"trainer": trainer.state_dict(), "position": position,
                                 "data_rng": data_rng},
                  serving=("HiFiGAN", config, trainer.serving_state_dict()), force=force)

    metrics, steps, t_start = {}, 0, time.perf_counter()
    start_epoch, skip = position
    for epoch in range(start_epoch, args.epochs):
        t0, n = time.perf_counter(), 0

        def produce(epoch=epoch, skip=skip if epoch == start_epoch else 0):
            for k, b in enumerate(ds.batches(batch_size, seed=config.seed + epoch,
                                             max_batches=args.steps_per_epoch,
                                             audio_only=not args.host_mels, skip=skip)):
                b["position"] = (epoch, skip + k + 1)
                b["data_rng"] = ds.rng.bit_generator.state
                yield b

        for batch in trainer.device_iter(produce()):
            position, data_rng = batch.pop("position"), batch.pop("data_rng")
            metrics = trainer.train_step(batch)
            n += 1
            if trainer.step % 100 == 0:
                print(f"epoch {epoch} step {trainer.step} " + " ".join(
                    f"{k}={float(v):.3f}" for k, v in sorted(metrics.items())))
            save(force=False)
        if n and device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        steps += n
        print(f"epoch {epoch}: {n} steps in {dt:.1f}s ({n * batch_size * config.segment_size / config.sampling_rate / max(dt, 1e-9):.1f}x "
              "realtime audio throughput)")
        position = (epoch + 1, 0)
        if (epoch + 1) % max(args.epochs_per_checkpoint, 1) == 0:
            save(force=True)
    save(force=True)
    metrics = {k: float(v) for k, v in metrics.items()}
    if metrics:
        print(f"step {trainer.step} " + " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items())))
    return {"trainer": trainer, "metrics": metrics, "steps": steps,
            "seconds": time.perf_counter() - t_start}


if __name__ == "__main__":
    main()
