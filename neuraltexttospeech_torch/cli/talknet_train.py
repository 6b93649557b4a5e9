"""TalkNet 2 training CLI: the QuartzNet CTC ASR (``--model asr``) or one of
the TTS heads (``duration``, ``pitch``, ``spectrogram``).

Port of ``talknet/train.py``, through the generic
:class:`~..train.harness.Trainer` with Adam (lr 1e-3, b2 0.999, eps 1e-8)
after a global-norm clip at 1.0. Each model's BatchNorm takes the batch's
statistics and updates its running buffers in the step's forward.

- ``asr``: ``-d`` is a ``wav|transcript`` filelist (``data/asr_dataset.py``:
  log-mels on the training device, B1 once per utterance on the card); the
  loss is the mean CTC over ``mel_lens // 2`` logits; after each step an
  eval-mode forward is greedily decoded, and each epoch reports its WER.
  ``--amp`` is accepted and ignored, as in the JAX CLI (its QuartzNet has no
  ``dtype``); ``--override`` applies to the ``QuartzNetConfig`` (the JAX CLI
  takes none for the ASR).
- ``duration``/``pitch``/``spectrogram``: ``-d`` is a
  ``fastspeech2_prepare_dataset`` directory (``cli/fastspeech2_train.py::
  FS2Dataset``); the losses are the masked duration MSE, the masked f0 MSE
  plus the voiced BCE averaged over all frames, and the masked mel L1; the
  frame targets expand the phone pitch through ``generate_path``.
  ``--amp`` sets ``TalkNet2Config.dtype`` to bf16 (the embeddings and the
  pitch conv; the backbone stays f32, as in JAX), ``--override key=value``
  changes any field (dotted keys reach ``backbone``).

f32 runs with TF32 off for cuBLAS and cuDNN. Checkpoints go to
``<output>/checkpoints/<step>/`` (``train_state.pt`` with the model, its
BatchNorm buffers, Adam's moments and the data order's position, and a
serving ``model.pt`` + ``model_config.json``, ``"QuartzNet"`` or
``"TalkNet2"`` with the front end). ``--resume`` continues from the newest
at the saved epoch and batch; the JAX CLI parses the flag and ignores it.

Usage:
  python -m neuraltexttospeech_torch.cli.talknet_train --model duration \\
      -o out/talknet-dur -d preprocessed/LJSpeech --epochs 100 [--device cpu]
"""

from __future__ import annotations

import argparse
import pathlib

import torch

from ..data.asr_dataset import VOCAB, ASRDataset
from ..models.gradtts import generate_path
from ..models.registry import apply_overrides, save_model_config
from ..models.talknet import (GraphemeDuration, PitchPredictor, QuartzNet, QuartzNetConfig,
                              SpectrogramModel, TalkNet2Config, ctc_loss, greedy_decode,
                              word_errors)
from ..parallel.distributed import launch
from ..parallel.mesh import global_count, global_mean
from ..train.harness import Trainer, TrainerConfig
from ..train.state import OptimizerConfig
from ..utils.masking import mask_from_lens
from .fastspeech2_train import FS2Dataset

HEADS = {"duration": GraphemeDuration, "pitch": PitchPredictor,
         "spectrogram": SpectrogramModel}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", required=True, choices=["asr", "duration", "pitch", "spectrogram"])
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-d", "--preprocessed-path", required=True,
                   help="fastspeech2-preprocessed dir (TTS heads) or filelist (asr)")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("-lr", "--learning-rate", type=float, default=1e-3)
    p.add_argument("-bs", "--batch-size", type=int, default=32)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --output")
    p.add_argument("--amp", action="store_true",
                   help="bf16 embeddings and pitch conv of the TTS heads (ignored by asr)")
    p.add_argument("--epochs-per-checkpoint", type=int, default=1)
    p.add_argument("--override", action="append", default=[],
                   help="config override key=value (repeatable, dotted keys e.g. "
                        "backbone.module_repeat=1)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain twins)")
    return p.parse_args(argv)


def optimizer_config(learning_rate: float) -> OptimizerConfig:
    """``optax.chain(clip_by_global_norm(1.0), adam(lr))``."""
    return OptimizerConfig(learning_rate=learning_rate, beta1=0.9, beta2=0.999, eps=1e-8,
                           grad_clip_norm=1.0)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * mask) / torch.clamp_min(global_count(torch.sum(mask)), 1.0)


def asr_loss_fn(model, batch, generator):
    logp = model(batch["mel"], generator)
    loss = ctc_loss(logp, batch["mel_lens"] // 2, batch["labels"], batch["label_lens"])
    return loss, {"ctc": loss}


def transcribe(model, batch):
    """The ASR's greedy transcripts of ``batch`` (an eval-mode forward, as
    JAX's CLI decodes after each step) and the batch's reference texts."""
    model.eval()
    with torch.no_grad():
        logp = model(batch["mel"])
    model.train()
    return [VOCAB.decode(ids) for ids in greedy_decode(logp, batch["mel_lens"] // 2)], \
        list(batch["texts"])


def corpus_wer(refs, hyps, mesh=None, device=None) -> float:
    """The WER of the transcripts; under a mesh each rank holds its rows'
    transcripts and the error and word counts are summed over the data
    group, so every rank has the global batch's WER."""
    counts = word_errors(refs, hyps)
    if mesh is not None:
        with mesh:
            counts = global_count(torch.tensor(counts, dtype=torch.int64, device=device)).tolist()
    return counts[0] / max(counts[1], 1)


def frame_pitch(batch) -> torch.Tensor:
    """The phone pitch [B, T_text] expanded to frames [B, T_mel] by the
    durations."""
    dur = batch["dur"]
    ones = torch.ones(dur.shape + (batch["mel"].shape[1],), device=dur.device)
    return torch.einsum("bxt,bx->bt", generate_path(dur, ones), batch["pitch"])


def duration_loss_fn(model, batch, generator):
    d = model(batch["text"], batch["input_lens"], generator)
    m = mask_from_lens(batch["input_lens"], batch["text"].shape[1]).float()
    loss = _masked_mean(torch.square(d - batch["dur"]), m)
    return loss, {"mse": loss}


def pitch_loss_fn(model, batch, generator):
    f0, voiced = model(batch["text"], batch["dur"], batch["mel"].shape[1], generator)
    tgt = frame_pitch(batch)
    m = mask_from_lens(batch["mel_lens"], batch["mel"].shape[1]).float()
    f0_loss = _masked_mean(torch.square(f0 - tgt), m)
    v_tgt = (tgt != 0).float()
    # a plain mean over every frame, padding included, as the JAX CLI's
    bce = global_mean((torch.relu(voiced) - voiced * v_tgt
                      + torch.log1p(torch.exp(-torch.abs(voiced)))) * m)
    return f0_loss + bce, {"f0_mse": f0_loss, "voiced_bce": bce}


def spectrogram_loss_fn(model, batch, generator):
    mel = model(batch["text"], batch["dur"], frame_pitch(batch), batch["mel"].shape[1],
                generator)
    m = mask_from_lens(batch["mel_lens"], batch["mel"].shape[1])[..., None].float()
    loss = _masked_mean(torch.abs(mel - batch["mel"]), m)
    return loss, {"mel_l1": loss}


LOSSES = {"asr": asr_loss_fn, "duration": duration_loss_fn, "pitch": pitch_loss_fn,
          "spectrogram": spectrogram_loss_fn}


def main(argv=None):
    """Train; returns ``{"trainer", "config", "metrics" (the last epoch's
    means, as floats, with ``wer`` for the ASR), "val" (empty: no validation
    set), "steps" (run by this call), "seconds"}``."""
    args = parse_args(argv)
    device, mesh = launch(args.device, args.batch_size)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = pathlib.Path(args.output)

    torch.manual_seed(args.seed)
    if args.model == "asr":
        ds = ASRDataset(args.preprocessed_path, device)
        config = apply_overrides(QuartzNetConfig(block_repeat=1, module_repeat=5), args.override)
        model, name, frontend = QuartzNet(config, len(VOCAB)), "QuartzNet", None
    else:
        ds = FS2Dataset(args.preprocessed_path)
        config = apply_overrides(TalkNet2Config(dtype=torch.bfloat16 if args.amp else None),
                                 args.override)
        model, name, frontend = HEADS[args.model](config), "TalkNet2", ds.frontend
    save_model_config(out, name, config, frontend=frontend)
    trainer = Trainer(
        LOSSES[args.model], model,
        TrainerConfig(optimizer=optimizer_config(args.learning_rate), seed=args.seed,
                      checkpoint_dir=str(out / "checkpoints")),
        device, serving=lambda: (name, config, model.state_dict(), frontend), mesh=mesh)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{name}/{args.model}: {n_params / 1e6:.1f}M params, {len(ds)} items, "
          f"{'bf16' if args.amp and args.model != 'asr' else 'f32'}, device {device}, "
          f"dp={mesh.n_data if mesh else 1}")

    def batches(epoch, skip):
        return ds.batches(args.batch_size, seed=args.seed + epoch,
                          max_batches=args.steps_per_epoch, skip=skip)

    asr, hyps, refs = args.model == "asr", [], []

    def on_step(batch):  # this rank's rows
        h, r = transcribe(model, batch)
        hyps.extend(h)
        refs.extend(r)

    def on_epoch(metrics):
        metrics["wer"] = corpus_wer(refs, hyps, mesh, device)
        hyps.clear()
        refs.clear()

    return {"trainer": trainer, "config": config, **trainer.fit(
        batches, args.epochs, resume=args.resume,
        epochs_per_checkpoint=args.epochs_per_checkpoint,
        on_step=on_step if asr else None, on_epoch=on_epoch if asr else None)}


if __name__ == "__main__":
    main()
