import dataclasses

from port_bench.faults import patched


def lamb_without_trust_ratio():
    """LAMB without its trust ratio: the update is AdamW's (the same moments,
    the same weight decay), not scaled per leaf by ``|p| / |u|``."""
    from neuraltexttospeech_torch.train import state

    def make(orig):
        def update(self, grads):
            config = self.config
            if config.optimizer == "lamb":
                self.config = dataclasses.replace(config, optimizer="adamw")
            try:
                return orig(self, grads)
            finally:
                self.config = config
        return update

    return patched(state.Optimizer, "_update", make)
