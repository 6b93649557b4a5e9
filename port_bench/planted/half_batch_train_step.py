from port_bench.faults import patched


def half_batch_train_step():
    """The trainer's step takes the first half of its batch's rows: every
    mean is over the rest. The run's records (dropout masks, MAS paths) then
    no longer fit the batch the reference is given."""
    from neuraltexttospeech_torch.train.harness import Trainer

    def make(orig):
        def step(self, batch):
            return orig(self, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
        return step

    return patched(Trainer, "train_step", make)
