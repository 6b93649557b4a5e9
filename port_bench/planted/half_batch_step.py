from port_bench.faults import patched


def half_batch_step():
    """The GAN step takes the first half of its batch: its means are over
    the rest."""
    from neuraltexttospeech_torch.models.hifigan_gan import HiFiGANTrainer

    def make(orig):
        def step(self, batch):
            return orig(self, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
        return step

    return patched(HiFiGANTrainer, "train_step", make)
