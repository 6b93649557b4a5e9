"""HiFi-GAN adversarial training step: generator, MPD and MSD with three Adams.

Counterpart of ``neuraltexttospeech_tpu/models/hifigan_gan.py`` (LSGAN, the
reference's 3-optimizer harness ``HiFiGAN_TF/gan.py:32-211``). One step:

- discriminator lane: ``y_hat = G(mel)`` detached; MPD and MSD real-vs-fake
  loss → grads for MPD and MSD. The MSD's spectral-norm stats are updated as
  flax does with ``update_stats=True``: the real pass writes ``u``, the fake
  pass starts from it.
- generator lane: adversarial + feature matching (×2) + 45·L1(mel(y_hat),
  mel_target) → grads for G, through the MPD and MSD with their pre-step
  parameters and pre-step spectral-norm stats.

Both lanes see the pre-step parameters, and only then are the three
optimizers stepped (the common PyTorch recipe steps D first; that is another
algorithm). The real pass is the same in both lanes (the same parameters and
the same starting ``u``), so it runs once and the generator lane reads its
feature maps detached. The mels run through kernel B1 (``ops/mel_kernel.py``)
on the card, with its analytic backward for the mel loss.

Given a data-parallel ``mesh`` (``parallel/mesh.py``) the step is JAX's
pjit step over the global batch: :meth:`HiFiGANTrainer.device_iter` takes
each rank's rows, the step runs both lanes on them inside ``with mesh:``
(every loss a mean over the global batch, so B1 ×3 and B2 ×90 run on each
rank's rows), one all-reduce of a flat buffer sums the three networks'
gradients over the data group and one more the metrics, and each Adam
steps on its network's reduced gradients. The three networks start from
rank 0's.

``dtype=torch.bfloat16`` is the JAX package's ``--amp`` (flax ``dtype=bf16``):
both lanes run their convs in bf16 (``nn/precision.py``; the MSD's through
B2's bf16 form), the generated audio is cast to f32 before its log-mel (B1 stays f32, as in
JAX), and the three Adams step the f32 parameters with f32 gradients.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, Optional

import torch
from torch.nn import functional as F

from ..audio.stft import STFTConfig
from ..data.prefetch import prefetch
from ..nn.norms import folded_state_dict
from ..nn.precision import compute_dtype
from ..ops.mel_kernel import fused_mel_spectrogram
from ..parallel.mesh import (FlatGrads, Mesh, global_mean, reduce_metrics, replicated,
                             shard_batch)
from .hifigan import (
    Generator, HiFiGANConfig, MultiPeriodDiscriminator, MultiScaleDiscriminator,
    discriminator_loss, feature_loss, generator_loss, resolve_msd_group_impl,
)

__all__ = ["loss_stft_config", "input_stft_config", "mel_for_loss", "HiFiGANTrainer",
           "init_params_", "learning_rate"]


def loss_stft_config(c: HiFiGANConfig) -> STFTConfig:
    """Mel settings of the reconstruction loss (``fmax_for_loss``, the
    Nyquist rate when unset)."""
    fmax = c.fmax_for_loss if c.fmax_for_loss is not None else c.sampling_rate / 2.0
    return STFTConfig(filter_length=c.n_fft, frame_length=c.win_size, frame_step=c.hop_size,
                      n_mel_channels=c.num_mels, sampling_rate=c.sampling_rate,
                      mel_fmin=c.fmin, mel_fmax=fmax)


def input_stft_config(c: HiFiGANConfig) -> STFTConfig:
    """Mel settings of the generator's input (fmin..fmax)."""
    return STFTConfig(filter_length=c.n_fft, frame_length=c.win_size, frame_step=c.hop_size,
                      n_mel_channels=c.num_mels, sampling_rate=c.sampling_rate,
                      mel_fmin=c.fmin, mel_fmax=c.fmax)


def mel_for_loss(audio: torch.Tensor, cfg: STFTConfig) -> torch.Tensor:
    """[B, S] audio → [B, S/hop, n_mel] log-mel with HiFi-GAN's centered
    reflect padding (``(n_fft - hop) / 2`` each side), through the
    differentiable fused log-mel (kernel B1 on the card, its twin on the
    CPU; the analytic backward on both), in f32 whatever the audio's type."""
    pad = (cfg.filter_length - cfg.frame_step) // 2
    audio = F.pad(audio.float()[:, None], (pad, pad), mode="reflect")[:, 0]
    return fused_mel_spectrogram(audio, cfg)


def init_params_(module: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    """flax-like initial values: lecun-normal weights and weight-norm ``v``
    (std ``1/sqrt(fan_in)``), unit weight-norm scales, zero biases."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif name.endswith("original1"):  # weight-norm scale
                p.fill_(1.0)
            else:
                p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)
    return module


def learning_rate(config: HiFiGANConfig, step: int, steps_per_epoch: int) -> float:
    """optax ``exponential_decay(lr, steps_per_epoch, lr_decay)`` at ``step``:
    ``lr * lr_decay ** (step / steps_per_epoch)``, continuous (not staircase)."""
    return config.learning_rate * config.lr_decay ** (step / steps_per_epoch)


class HiFiGANTrainer:
    """The GAN train state (G with weight norm, MPD, MSD with its
    spectral-norm buffers, three Adams, the step) and :meth:`train_step`.

    The learning rate follows :func:`learning_rate` at the pre-update step;
    ``dtype`` is the step's compute dtype (None: f32; bf16: the module
    docstring); ``mesh`` a data-parallel mesh (None: one card)."""

    def __init__(self, config: HiFiGANConfig, device, steps_per_epoch: int = 1000,
                 dtype: Optional[torch.dtype] = None, mesh: Optional[Mesh] = None):
        if mesh is not None and mesh.n_model != 1:
            raise ValueError("the GAN step shards the batch only: give it a mesh with n_model=1")
        self.config = config
        self.device = torch.device(device)
        self.steps_per_epoch = steps_per_epoch
        self.dtype = dtype
        self.mesh = mesh
        self.msd_group_impl = resolve_msd_group_impl(config.fast_grouped_convs)
        gen = torch.Generator().manual_seed(config.seed)
        self.gen = init_params_(Generator(config, weight_norm=True), gen).to(self.device)
        self.mpd = init_params_(MultiPeriodDiscriminator(), gen).to(self.device)
        self.msd = init_params_(MultiScaleDiscriminator(self.msd_group_impl, generator=gen),
                                gen).to(self.device)
        if mesh is not None:
            for net in (self.gen, self.mpd, self.msd):
                replicated(net, mesh)
            self._params = [p for net in (self.gen, self.mpd, self.msd) for p in net.parameters()]
            self._flat_grads = FlatGrads(self._params)
        self.step = 0
        adam = dict(lr=config.learning_rate, betas=(config.adam_b1, config.adam_b2), eps=1e-8)
        self.optimizers = {name: torch.optim.Adam(getattr(self, name).parameters(), **adam)
                           for name in ("gen", "mpd", "msd")}
        self.loss_cfg = loss_stft_config(config)
        self.input_cfg = input_stft_config(config)

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One GAN step on ``batch``: ``audio [B, S, 1]`` and optionally
        ``mel`` / ``mel_loss`` [B, S/hop, n_mel] (an audio-only batch computes
        both in the step); under a mesh, this rank's rows of the global batch
        (:meth:`device_iter`'s). Returns the metrics as 0-d f32 tensors on
        the device."""
        metrics = self.losses_and_grads(batch)
        lr = learning_rate(self.config, self.step, self.steps_per_epoch)  # pre-update step
        for opt in self.optimizers.values():
            for group in opt.param_groups:
                group["lr"] = lr
            opt.step()
        self.step += 1
        return metrics

    def device_iter(self, batches: Iterable[Dict[str, torch.Tensor]]):
        """The batches on the trainer's device, sharded under a mesh (this
        rank's rows) and copied by a background thread."""
        if self.mesh is not None:
            batches = (shard_batch(b, self.mesh) for b in batches)
        return prefetch(batches, self.device)

    def losses_and_grads(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Both lanes' losses on ``batch`` and the three networks' gradients
        in their ``.grad`` (under a mesh: summed over the data group), without
        an update; ``batch`` as :meth:`train_step`'s. Returns the metrics as
        0-d f32 tensors."""
        with compute_dtype(self.dtype), self.mesh or contextlib.nullcontext():
            metrics = self._losses_and_grads(batch)
        metrics = {k: v.detach().float() for k, v in metrics.items()}
        if self.mesh is None:
            return metrics
        for p in self._params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self._flat_grads.all_reduce_([p.grad for p in self._params], self.mesh)
        return reduce_metrics(metrics, self.mesh)

    def _losses_and_grads(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        y = batch["audio"]
        if "mel" in batch:
            mel, mel_target = batch["mel"], batch["mel_loss"]
        else:
            with torch.no_grad():
                mel = mel_for_loss(y[..., 0], self.input_cfg)
                mel_target = mel_for_loss(y[..., 0], self.loss_cfg)
        for opt in self.optimizers.values():
            opt.zero_grad(set_to_none=True)

        y_hat = self.gen(mel)
        y_hat_mel = mel_for_loss(y_hat[..., 0], self.loss_cfg)
        loss_mel = global_mean(torch.abs(y_hat_mel - mel_target)) * 45.0

        # generator lane: pre-step discriminators, pre-step SN stats, no
        # discriminator grads
        disc_params = list(self.mpd.parameters()) + list(self.msd.parameters())
        for p in disc_params:
            p.requires_grad_(False)
        try:
            df_g, fmap_f_g = self.mpd.scores(y_hat)
            ds_g, fmap_s_g = self.msd.scores(y_hat, update_stats=False)
        finally:
            for p in disc_params:
                p.requires_grad_(True)

        # discriminator lane (real pass shared with the generator lane)
        df_r, fmap_f_r = self.mpd.scores(y)
        ds_r, fmap_s_r = self.msd.scores(y, update_stats=True)
        y_hat_d = y_hat.detach()
        df_gd, _ = self.mpd.scores(y_hat_d)
        ds_gd, _ = self.msd.scores(y_hat_d, update_stats=True)
        loss_mpd, _, _ = discriminator_loss(df_r, df_gd)
        loss_msd, _, _ = discriminator_loss(ds_r, ds_gd)
        d_loss = loss_mpd + loss_msd

        def detached(fmaps):
            return [[f.detach() for f in per_d] for per_d in fmaps]

        loss_fm = (feature_loss(detached(fmap_f_r), fmap_f_g)
                   + feature_loss(detached(fmap_s_r), fmap_s_g))
        loss_adv = generator_loss(df_g)[0] + generator_loss(ds_g)[0]
        g_loss = loss_adv + loss_fm + loss_mel
        # the lanes share no parameter, so one backward gives both lanes' grads
        (g_loss + d_loss).backward()
        return {"gen_loss": g_loss, "mel_l1_x45": loss_mel, "fm_loss": loss_fm,
                "adv_loss": loss_adv, "disc_loss": d_loss, "disc_mpd": loss_mpd,
                "disc_msd": loss_msd}

    # ------------------------------------------------------------ state
    def state_dict(self) -> dict:
        return {"step": self.step, "gen": self.gen.state_dict(), "mpd": self.mpd.state_dict(),
                "msd": self.msd.state_dict(),
                "optimizers": {k: o.state_dict() for k, o in self.optimizers.items()}}

    def load_state_dict(self, state: dict):
        self.step = int(state["step"])
        for name in ("gen", "mpd", "msd"):
            getattr(self, name).load_state_dict(state[name])
        for name, opt in self.optimizers.items():
            opt.load_state_dict(state["optimizers"][name])

    def serving_state_dict(self) -> dict:
        """The generator with weight norm folded: the serving checkpoint's
        ``model.pt``."""
        return folded_state_dict(self.gen)
