#!/usr/bin/env python3
"""Hold the PyTorch port's sharded training steps against the one-process
step, in N processes of one ``torch.distributed`` run.

    python3 tools/torch_parallel_check.py --nproc 2 --cases fastpitch,talknet \\
        [--device cuda|cpu] [--backend gloo|nccl] [--tp 2] [--timeout 300] [--start DIR]

Each process joins the run through ``parallel.initialize_distributed``
(the default ``--device cuda`` puts every rank on ``cuda:0`` and raises
without a card; give ``--backend gloo`` for more than one rank on one card,
``--device cpu`` for gloo on the CPU). For each case it builds a small model
from a seed and a global batch from numpy (ragged lengths where the family
has lengths), runs the one-process step on the whole batch, then the sharded
step on its rows, and prints one ``RESULT {json}`` line per case with the
errors against the one-process step, each as a ratio to its tolerance
(``np.allclose``'s ``|a − b| ≤ atol + rtol·|b|``: at most 1 passes):

- the data-parallel cases (``--nproc / --tp`` data shards for ``tp``,
  ``--nproc`` for the others): every metric (the loss among them) at
  ``tests/test_multichip.py``'s rtol/atol 2e-5, every gradient at 2e-4, the
  parameters after the update at 3e-5 (the GAN step at 2e-4, as JAX's full
  GAN step test), and the BatchNorm buffers at 1e-5 and equal on every
  rank. Dropout is on (the trainer's per-step generator).
  ``fastpitch``, ``fastspeech2``, ``tacotron2``, ``gradtts``, ``flowtron``,
  ``talknet`` (the spectrogram head), ``diffwave`` and ``asr`` (the
  QuartzNet CTC ASR) go through ``train/harness.py::Trainer`` with their
  CLIs' loss functions; ``asr`` also holds the CLI's corpus WER over the
  ranks' own transcripts (``cli/talknet_train.py::corpus_wer``) to the
  one-process WER, exactly; ``gan`` is the full three-network step of
  ``models/hifigan_gan.py`` with a small generator and the full MPD and
  MSD;
- ``tp``: FastPitch with 2 heads (qkv split by heads) and with 1 head (qkv
  replicated, ``o`` row-parallel) on an ``nproc/tp × tp`` mesh
  (``parallel/tp.py``): the loss at 2e-5 and each rank's slices of the
  gradients at 2e-4 against the replicated step's.

With ``--start DIR``, for each case that has ``DIR/<case>.start.pt`` (a
state dict), each rank also loads it into the case's model with dropout off,
takes its sharded step's gradients and writes ``DIR/<case>.rank<r>.pt``
(the reduced metrics, the reduced gradients by parameter name, the
BatchNorm buffers): an outside reference, such as the JAX package's step on
the same global batch and weights, is then held against every rank
(``tests/test_torch_parallel.py``).

On the card it also reports each rank's launches of kernels B1, B2 and MAS
in the sharded step. The command exits non-zero if a case misses a
tolerance or a process fails or outlives ``--timeout``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
B = 4  # the global batch: 4 rows, divisible by 1, 2 and 4 data shards
DP_CASES = ("fastpitch", "fastspeech2", "tacotron2", "gradtts", "flowtron", "talknet",
            "diffwave", "gan", "asr")
FP_CFG = dict(n_symbols=40, symbols_embedding_dim=32, in_fft_n_layers=1, in_fft_n_heads=2,
              in_fft_d_head=8, in_fft_conv1d_filter_size=64, out_fft_n_layers=1,
              out_fft_n_heads=2, out_fft_d_head=8, out_fft_conv1d_filter_size=64,
              dur_predictor_filter_size=16, pitch_predictor_filter_size=16,
              energy_predictor_filter_size=16)
# the TalkNet 2 spectrogram head of the ``talknet`` case, and the ASR's backbone
TN_BACKBONE = dict(block_repeat=1, module_repeat=1,
                   block_params=((16, 5), (16, 5), (24, 5), (24, 5), (24, 5)),
                   initial_filters=16, initial_kernel=5, penultimate_filters=24,
                   penultimate_kernel=7, final_filters=32)
TN_HEAD = dict(n_symbols=40, emb_dim=32, n_mel_channels=8)


def ratio(got, want, rtol, atol) -> float:
    """max |got − want| / (atol + rtol·|want|): at most 1 passes."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise ValueError(f"shape {got.shape} != {want.shape}")
    return float(np.max(np.abs(got - want) / (atol + rtol * np.abs(want)), initial=0.0))


# ------------------------------------------------------------------ the cases


def _lens_mask(lens, t):
    return np.arange(t)[None] < np.asarray(lens)[:, None]


def fastpitch_case(rng, dropout=True):
    import dataclasses

    from neuraltexttospeech_torch.cli.fastpitch_train import make_loss_fn
    from neuraltexttospeech_torch.models.fastpitch import FastPitch, FastPitchConfig
    from neuraltexttospeech_torch.models.fastpitch_loss import FastPitchLossConfig

    t_text, t_mel = 8, 16
    text_lens, mel_lens = np.array([8, 5, 8, 6], np.int32), np.array([16, 11, 13, 16], np.int32)
    text = rng.integers(1, 40, (B, t_text)) * _lens_mask(text_lens, t_text)
    batch = {"text": text.astype(np.int64), "input_lens": text_lens,
             "mel": (rng.standard_normal((B, t_mel, 80))
                     * _lens_mask(mel_lens, t_mel)[..., None]).astype(np.float32),
             "mel_lens": mel_lens,
             "pitch": rng.standard_normal((B, 1, t_mel)).astype(np.float32),
             "energy": np.abs(rng.standard_normal((B, t_mel))).astype(np.float32)}
    cfg = FastPitchConfig(**FP_CFG)
    if not dropout:
        cfg = dataclasses.replace(cfg, **{f.name: 0.0 for f in dataclasses.fields(cfg)
                                          if f.name.startswith("p_")})
    return lambda: FastPitch(cfg), make_loss_fn(FastPitchLossConfig(), 1), batch


def fastspeech2_case(rng):
    from neuraltexttospeech_torch.cli.fastspeech2_train import loss_fn
    from neuraltexttospeech_torch.models.fastspeech2 import FastSpeech2, FastSpeech2Config

    t_text, text_lens = 8, np.array([8, 5, 8, 6], np.int32)
    dur = rng.integers(1, 4, (B, t_text)) * _lens_mask(text_lens, t_text)
    mel_lens = dur.sum(1).astype(np.int32)
    t_mel = int(mel_lens.max())
    batch = {"text": (rng.integers(1, 40, (B, t_text)) * _lens_mask(text_lens, t_text)),
             "input_lens": text_lens, "dur": dur.astype(np.float32),
             "pitch": rng.standard_normal((B, t_text)).astype(np.float32),
             "energy": rng.standard_normal((B, t_text)).astype(np.float32),
             "mel": rng.standard_normal((B, t_mel, 80)).astype(np.float32),
             "mel_lens": mel_lens}
    cfg = FastSpeech2Config(n_symbols=40, encoder_layer=1, decoder_layer=1, encoder_hidden=32,
                            decoder_hidden=32, conv_filter_size=64, variance_filter_size=16,
                            n_bins=16, postnet_dim=24, postnet_layers=2)
    return lambda: FastSpeech2(cfg), loss_fn, batch


def tacotron2_case(rng):
    from neuraltexttospeech_torch.models.tacotron2 import Tacotron2, Tacotron2Config
    from neuraltexttospeech_torch.models.tacotron2_train import loss_fn

    t_text, t_mel = 9, 20
    text_lens, mel_lens = np.array([9, 6, 9, 7], np.int32), np.array([20, 14, 20, 16], np.int32)
    batch = {"text": rng.integers(1, 40, (B, t_text)) * _lens_mask(text_lens, t_text),
             "input_lens": text_lens,
             "mel": (rng.standard_normal((B, t_mel, 80)) * 0.5).astype(np.float32),
             "mel_lens": mel_lens}
    cfg = Tacotron2Config(n_symbols=40, symbols_embedding_dim=32, encoder_embedding_dim=32,
                          decoder_rnn_dim=48, attention_rnn_dim=48, attention_dim=16,
                          attention_location_n_filters=4, attention_location_kernel_size=7,
                          prenet_dim=16, postnet_embedding_dim=24, postnet_n_convolutions=3,
                          max_decoder_steps=40)
    return lambda: Tacotron2(cfg), loss_fn, batch


def gradtts_case(rng):
    from neuraltexttospeech_torch.cli.gradtts_train import make_loss_fn
    from neuraltexttospeech_torch.models.gradtts import GradTTS, GradTTSConfig

    t_text, t_mel = 11, 32
    text_lens, mel_lens = np.array([11, 7, 11, 9], np.int32), np.array([32, 24, 32, 28], np.int32)
    batch = {"text": rng.integers(1, 40, (B, t_text)) * _lens_mask(text_lens, t_text),
             "input_lens": text_lens,
             "mel": rng.standard_normal((B, t_mel, 80)).astype(np.float32),
             "mel_lens": mel_lens}
    cfg = GradTTSConfig(n_symbols=40, n_enc_channels=32, filter_channels=64,
                        filter_channels_dp=32, n_enc_layers=2, dec_dim=8, out_size=16)
    return lambda: GradTTS(cfg), make_loss_fn(cfg.out_size), batch


def flowtron_case(rng):
    from neuraltexttospeech_torch.cli.flowtron_train import make_loss_fn
    from neuraltexttospeech_torch.models.flowtron import Flowtron, FlowtronConfig

    t_text, t_mel = 7, 12
    text_lens, mel_lens = np.array([7, 5, 7, 6], np.int32), np.array([12, 9, 12, 10], np.int32)
    batch = {"text": rng.integers(1, 40, (B, t_text)) * _lens_mask(text_lens, t_text),
             "input_lens": text_lens,
             "mel": rng.standard_normal((B, t_mel, 8)).astype(np.float32),
             "mel_lens": mel_lens, "speaker": np.zeros((B,), np.int64)}
    cfg = FlowtronConfig(n_text=40, n_text_dim=32, n_flows=2, n_mel_channels=8,
                         n_attn_channels=16, n_hidden=24, mel_encoder_n_hidden=16,
                         n_speaker_dim=8)
    return lambda: Flowtron(cfg), make_loss_fn(), batch


def talknet_case(rng, dropout=True):
    from neuraltexttospeech_torch.cli.talknet_train import spectrogram_loss_fn
    from neuraltexttospeech_torch.models.talknet import (QuartzNetConfig, SpectrogramModel,
                                                         TalkNet2Config)

    t_text, text_lens = 6, np.array([6, 4, 6, 5], np.int32)
    dur = rng.integers(1, 4, (B, t_text)) * _lens_mask(text_lens, t_text)
    mel_lens = dur.sum(1).astype(np.int32)
    t_mel = int(mel_lens.max())
    batch = {"text": rng.integers(1, 40, (B, t_text)) * _lens_mask(text_lens, t_text),
             "input_lens": text_lens, "dur": dur.astype(np.int64),
             "pitch": rng.standard_normal((B, t_text)).astype(np.float32),
             "mel": rng.standard_normal((B, t_mel, 8)).astype(np.float32),
             "mel_lens": mel_lens}
    cfg = TalkNet2Config(**TN_HEAD, backbone=QuartzNetConfig(**TN_BACKBONE))

    def make_model():
        model = SpectrogramModel(cfg)
        if not dropout:
            model.backbone.p_dropout = 0.0
        return model

    return make_model, spectrogram_loss_fn, batch


def asr_case(rng):
    from neuraltexttospeech_torch.cli.talknet_train import VOCAB, asr_loss_fn
    from neuraltexttospeech_torch.models.talknet import QuartzNet, QuartzNetConfig

    t_mel, mel_lens = 64, np.array([64, 50, 64, 56], np.int32)
    label_lens = np.array([16, 6, 12, 9], np.int32)
    words = ["the", "cat", "sat", "on", "a", "mat", "dog", "ran"]
    batch = {"mel": (rng.standard_normal((B, t_mel, 80))
                     * _lens_mask(mel_lens, t_mel)[..., None]).astype(np.float32),
             "mel_lens": mel_lens,
             "labels": (rng.integers(1, len(VOCAB), (B, 16))
                        * _lens_mask(label_lens, 16)).astype(np.int64),
             "label_lens": label_lens,
             "texts": [" ".join(rng.choice(words, 2 + i)) for i in range(B)]}
    return lambda: QuartzNet(QuartzNetConfig(**TN_BACKBONE), len(VOCAB)), asr_loss_fn, batch


def diffwave_case(rng):
    from neuraltexttospeech_torch.cli.diffwave_train import make_loss_fn
    from neuraltexttospeech_torch.models.diffwave import DiffWave, DiffWaveConfig

    cfg = DiffWaveConfig(residual_layers=4, residual_channels=16, dilation_cycle_length=4,
                         crop_mel_frames=4, n_mels=8, hop_length=16)
    batch = {"audio": rng.standard_normal((B, 64, 1)).astype(np.float32),
             "mel": rng.standard_normal((B, 4, 8)).astype(np.float32)}
    return lambda: DiffWave(cfg), make_loss_fn(False), batch


CASES = {"fastpitch": fastpitch_case, "fastspeech2": fastspeech2_case,
         "tacotron2": tacotron2_case, "gradtts": gradtts_case, "flowtron": flowtron_case,
         "talknet": talknet_case, "diffwave": diffwave_case, "asr": asr_case}


# ---------------------------------------------------------------- the checks


def _counters():
    from neuraltexttospeech_torch.ops import gouter_kernel, mas_kernel, mel_kernel

    return {"B1": mel_kernel.fused_frames_to_mel, "B2": gouter_kernel.gouter_tap_dots_kernel,
            "MAS": mas_kernel.maximum_path}


def _zero_counts():
    for fn in _counters().values():
        fn.launches = 0


def _read_counts():
    return {k: fn.launches for k, fn in _counters().items()}


def _on(batch, device):
    """The batch's numpy arrays as tensors on ``device``; lists pass through."""
    import torch

    return {k: torch.as_tensor(v, device=device) if isinstance(v, np.ndarray) else v
            for k, v in batch.items()}


def _buffers(model):
    return {k: v.detach().cpu().numpy() for k, v in model.named_buffers()
            if k.endswith(("running_mean", "running_var"))}


def _same_on_every_rank(arrays, group) -> float:
    """Largest difference between this rank's ``arrays`` and any rank's."""
    import torch.distributed as dist

    if not arrays:
        return 0.0
    flat = np.concatenate([a.reshape(-1) for a in arrays])
    gathered = [None] * dist.get_world_size(group)
    dist.all_gather_object(gathered, flat, group=group)
    return max(float(np.abs(g - flat).max()) for g in gathered)


def check_trainer_case(name, device, mesh):
    """The Trainer's step on the whole batch, then sharded."""
    import torch
    from neuraltexttospeech_torch.train.harness import Trainer, TrainerConfig
    from neuraltexttospeech_torch.train.state import OptimizerConfig

    from neuraltexttospeech_torch.cli.talknet_train import corpus_wer, transcribe
    from neuraltexttospeech_torch.parallel.mesh import shard_batch

    make_model, loss_fn, batch = CASES[name](np.random.default_rng(DP_CASES.index(name)))
    batch = _on(batch, device)
    # Adam's eps at 1e-4: the conv biases before a norm have gradients that
    # are zero but for rounding (the reduction order sets it, ~1e-6 here), and
    # the first update is lr·g/(|g| + eps), so a small eps would turn that
    # rounding into parameter moves of up to a whole lr
    cfg = TrainerConfig(optimizer=OptimizerConfig(learning_rate=1e-3, eps=1e-4), seed=7)
    out = {}
    for tag, m in (("ref", None), ("dp", mesh)):
        torch.manual_seed(0)
        trainer = Trainer(loss_fn, make_model(), cfg, device, mesh=m)
        if tag == "dp":
            _zero_counts()
        metrics, grads = trainer.gradients(batch if m is None else shard_batch(batch, m))
        counts = _read_counts()
        if name == "asr" and m is not None:  # the CLI's WER: this rank's rows, then global
            # references that the one-process transcripts match in the even
            # rows and miss by i words in odd row i, so that pairing a rank's
            # transcripts with other rows' references changes the WER
            hyps = transcribe(trainer.model, batch)[0]
            batch["texts"] = [h if i % 2 == 0 else "zz " * i + h for i, h in enumerate(hyps)]
            wer = (corpus_wer(batch["texts"], hyps),
                   corpus_wer(*reversed(transcribe(trainer.model, shard_batch(batch, m))),
                              m, device))
        trainer.optimizer.step(grads)
        out[tag] = ({k: float(v) for k, v in metrics.items()},
                    [g.detach().cpu().numpy() for g in grads],
                    [p.detach().cpu().numpy() for p in trainer.params],
                    _buffers(trainer.model), counts)
    (m_ref, g_ref, p_ref, b_ref, _), (m_dp, g_dp, p_dp, b_dp, counts) = out["ref"], out["dp"]
    return {**({"wer": wer[1] - wer[0], "wer_global": wer[0]} if name == "asr" else {}),
            "metrics": max(ratio(m_dp[k], m_ref[k], 2e-5, 2e-5) for k in m_ref),
            "loss": ratio(m_dp["loss"], m_ref["loss"], 2e-5, 2e-5),
            "grads": max(ratio(a, b, 2e-4, 2e-4) for a, b in zip(g_dp, g_ref)),
            "params": max(ratio(a, b, 0.0, 3e-5) for a, b in zip(p_dp, p_ref)),
            "buffers": max((ratio(b_dp[k], b_ref[k], 1e-5, 1e-6) for k in b_ref), default=0.0),
            "buffers_rank_spread": _same_on_every_rank(list(b_dp.values()), mesh.group),
            "n_buffers": len(b_dp), "launches": counts}


def check_gan_case(device, mesh):
    """The three-network GAN step on the whole batch, then sharded."""
    import torch
    from neuraltexttospeech_torch.models.hifigan import HiFiGANConfig
    from neuraltexttospeech_torch.models.hifigan_gan import HiFiGANTrainer
    from neuraltexttospeech_torch.parallel.mesh import shard_batch

    cfg = HiFiGANConfig(resblock="2", upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                        upsample_initial_channel=32, resblock_kernel_sizes=(3,),
                        resblock_dilation_sizes=((1, 2),), n_fft=64, hop_size=16,
                        win_size=64, segment_size=256, num_mels=8,
                        fast_grouped_convs="gdot_pallas")
    rng = np.random.default_rng(DP_CASES.index("gan"))
    audio = torch.as_tensor((rng.standard_normal((B, 256, 1)) * 0.1).astype(np.float32),
                            device=device)
    out = {}
    for tag, m in (("ref", None), ("dp", mesh)):
        trainer = HiFiGANTrainer(cfg, device, mesh=m)
        if tag == "dp":
            _zero_counts()
        batch = {"audio": audio}
        metrics = trainer.losses_and_grads(batch if m is None else shard_batch(batch, m))
        counts = _read_counts()
        nets = [getattr(trainer, n) for n in ("gen", "mpd", "msd")]
        grads = [p.grad.cpu().numpy() for net in nets for p in net.parameters()]
        for opt in trainer.optimizers.values():
            opt.step()
        state = [v.detach().cpu().numpy() for net in nets for v in net.state_dict().values()]
        out[tag] = ({k: float(v) for k, v in metrics.items()}, grads, state, counts)
    (m_ref, g_ref, s_ref, _), (m_dp, g_dp, s_dp, counts) = out["ref"], out["dp"]
    return {"metrics": max(ratio(m_dp[k], m_ref[k], 2e-4, 2e-4) for k in m_ref),
            "loss": ratio(m_dp["gen_loss"], m_ref["gen_loss"], 2e-4, 2e-4),
            "grads": max(ratio(a, b, 2e-4, 2e-4) for a, b in zip(g_dp, g_ref)),
            "params": max(ratio(a, b, 2e-4, 2e-4) for a, b in zip(s_dp, s_ref)),
            "buffers": 0.0, "buffers_rank_spread": 0.0, "n_buffers": 0, "launches": counts}


def check_tp_case(device, mesh, n_heads):
    """FastPitch's loss and gradients on the dp × tp mesh against the
    replicated step."""
    import torch
    from neuraltexttospeech_torch.models.fastpitch import FastPitch, FastPitchConfig
    from neuraltexttospeech_torch.parallel.mesh import (FlatGrads, reduce_metrics, replicated,
                                                        shard_batch)
    from neuraltexttospeech_torch.parallel.tp import local_slice, shard_params_tp, tp_param_specs
    from neuraltexttospeech_torch.train.harness import step_generator

    _, loss_fn, batch = fastpitch_case(np.random.default_rng(0))
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    cfg = FastPitchConfig(**{**FP_CFG, "in_fft_n_heads": n_heads, "out_fft_n_heads": n_heads,
                             "in_fft_d_head": 16 // n_heads, "out_fft_d_head": 16 // n_heads})
    out = {}
    for tag in ("ref", "tp"):
        torch.manual_seed(0)
        model = FastPitch(cfg).to(device)
        specs = tp_param_specs(model, model_axis_size=mesh.n_model)
        b, ctx = batch, None
        if tag == "tp":
            replicated(model, mesh)
            shard_params_tp(model, mesh)
            b, ctx = shard_batch(batch, mesh), mesh
        gen = step_generator(7, 0, device)
        with ctx if ctx is not None else contextlib.nullcontext():
            loss, _ = loss_fn(model, b, gen)
        names = [n for n, _ in model.named_parameters()]
        grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(model.parameters(), grads)]
        loss = loss.detach()
        if tag == "tp":  # as the trainers reduce over the data group
            grads = FlatGrads(model.parameters()).all_reduce_(grads, mesh)
            loss = reduce_metrics({"loss": loss}, mesh)["loss"]
        else:  # this rank's slices of the replicated gradients
            grads = [g if specs[n] is None
                     else local_slice(g, specs[n], mesh.n_model, mesh.model_index)
                     for n, g in zip(names, grads)]
        out[tag] = (float(loss), [g.cpu().numpy() for g in grads])
    n_sharded = sum(s is not None for s in specs.values())
    return {"loss": ratio(out["tp"][0], out["ref"][0], 2e-5, 2e-5), "metrics": 0.0,
            "grads": max(ratio(a, b, 2e-4, 2e-4) for a, b in zip(out["tp"][1], out["ref"][1])),
            "params": 0.0, "buffers": 0.0, "buffers_rank_spread": 0.0, "n_buffers": 0,
            "n_sharded": n_sharded, "launches": {}}


def dump_sharded_step(name, device, mesh, start):
    """The case's sharded ``Trainer`` step from the weights in
    ``start/<name>.start.pt`` with dropout off, written to
    ``start/<name>.rank<r>.pt``: the reduced metrics and gradients and the
    BatchNorm buffers after the step's forward."""
    import torch
    from neuraltexttospeech_torch.parallel.mesh import shard_batch
    from neuraltexttospeech_torch.train.harness import Trainer, TrainerConfig

    make_model, loss_fn, batch = CASES[name](np.random.default_rng(DP_CASES.index(name)),
                                             dropout=False)
    model = make_model()
    model.load_state_dict(torch.load(start / f"{name}.start.pt"))
    trainer = Trainer(loss_fn, model, TrainerConfig(seed=7), device, mesh=mesh)
    metrics, grads = trainer.gradients(shard_batch(_on(batch, device), mesh))
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    torch.save({"metrics": {k: float(v) for k, v in metrics.items()},
                "grads": {n: g.detach().cpu() for n, g in zip(names, grads)},
                "buffers": {k: torch.as_tensor(v) for k, v in _buffers(model).items()}},
               start / f"{name}.rank{mesh.rank}.pt")


def worker(args):
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from neuraltexttospeech_torch.parallel import initialize_distributed, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    if not initialize_distributed(args.address, args.nproc, args.rank, device=device,
                                  backend=args.backend):
        raise RuntimeError("no process group")
    if device.type == "cuda":
        from neuraltexttospeech_torch.ops import _build, gouter_kernel, mas_kernel, mel_kernel

        for source in (mel_kernel.SOURCE, gouter_kernel.SOURCE, mas_kernel.SOURCE):
            _build.load(source)
    dp_mesh = make_mesh(args.nproc)
    tp_mesh = make_mesh(args.nproc // args.tp, args.tp) if "tp" in args.cases else None
    for name in args.cases:
        t0 = time.perf_counter()
        if name == "tp":
            for heads in (2, 1):
                res = check_tp_case(device, tp_mesh, heads)
                res.update(case=f"tp{heads}h", mesh=[tp_mesh.n_data, tp_mesh.n_model])
                _emit(res, args.rank, t0)
            continue
        res = (check_gan_case(device, dp_mesh) if name == "gan"
               else check_trainer_case(name, device, dp_mesh))
        res.update(case=name, mesh=[dp_mesh.n_data, 1])
        _emit(res, args.rank, t0)
    if args.start is not None:
        start = pathlib.Path(args.start)
        for name in args.cases:
            if (start / f"{name}.start.pt").exists():
                dump_sharded_step(name, device, dp_mesh, start)
    dist.destroy_process_group()


def _emit(res, rank, t0):
    res.update(rank=rank, seconds=round(time.perf_counter() - t0, 2))
    print("RESULT " + json.dumps(res), flush=True)


def passed(res) -> bool:
    return (max(res["loss"], res["metrics"], res["grads"], res["params"], res["buffers"]) <= 1.0
            and res["buffers_rank_spread"] == 0.0 and res.get("wer", 0.0) == 0.0)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(nproc, cases, device="cuda", backend=None, tp=2, timeout=300.0, start=None):
    """Run the check in ``nproc`` processes (``start``: ``--start``'s
    directory); returns (every RESULT, the processes' output). Raises if a
    process fails or outlives ``timeout``."""
    address = f"127.0.0.1:{free_port()}"
    env = {**os.environ, "OMP_NUM_THREADS": os.environ.get("OMP_NUM_THREADS", "2")}
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--worker", str(rank), "--address", address,
         "--nproc", str(nproc), "--cases", ",".join(cases), "--device", device,
         "--backend", backend or ("gloo" if device == "cpu" else "nccl"), "--tp", str(tp)]
        + (["--start", str(start)] if start is not None else []),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for rank in range(nproc)]
    deadline, outs = time.monotonic() + timeout, []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise RuntimeError(f"the {nproc} processes did not finish within {timeout} s")
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {rank} exited {p.returncode}:\n{out[-4000:]}")
    results = [json.loads(line[len("RESULT "):]) for out in outs
               for line in out.splitlines() if line.startswith("RESULT ")]
    return results, outs


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--nproc", type=int, default=2)
    parser.add_argument("--cases", default="fastpitch,talknet",
                        help="comma-separated: " + ", ".join(DP_CASES + ("tp",)))
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--backend", choices=("gloo", "nccl"), default=None)
    parser.add_argument("--tp", type=int, default=2, help="model-axis size of the tp case")
    parser.add_argument("--timeout", type=float, default=300.0)
    parser.add_argument("--start", default=None,
                        help="directory of <case>.start.pt weights: dump each rank's step")
    parser.add_argument("--worker", type=int, default=None, dest="rank")
    parser.add_argument("--address", default=None)
    args = parser.parse_args()
    args.cases = [c for c in args.cases.split(",") if c]
    unknown = set(args.cases) - set(DP_CASES + ("tp",))
    if unknown:
        parser.error(f"unknown cases {sorted(unknown)}")
    if args.rank is not None:
        worker(args)
        return 0
    results, _ = run(args.nproc, args.cases, args.device, args.backend, args.tp, args.timeout,
                     args.start)
    for res in results:
        print(("PASS " if passed(res) else "FAIL ") + json.dumps(res), flush=True)
    expected = args.nproc * sum(2 if c == "tp" else 1 for c in args.cases)
    return 0 if len(results) == expected and all(map(passed, results)) else 1


if __name__ == "__main__":
    sys.exit(main())
