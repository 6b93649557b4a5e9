from port_bench.faults import patched


def accumulation_drops_half():
    """The optimizer's accumulation (``train/state.py``) drops the gradients
    of the first half of each update's micro-steps: the update's gradient is
    the mean over the second half, half of the batch left out and the mean
    taken over the rest."""
    import torch

    from neuraltexttospeech_torch.train import state

    def make(orig):
        def step(self, grads):
            k = self.config.grad_accum_steps
            if k == 1:
                return orig(self, grads)
            if self.mini_step < k // 2:
                self.mini_step += 1
                return False
            with torch.no_grad():  # the running mean over the kept micro-steps
                grads = [torch.zeros_like(p) if g is None else g
                         for p, g in zip(self.params, grads)]
                diff = torch._foreach_sub(grads, self.acc)
                torch._foreach_div_(diff, float(self.mini_step - k // 2 + 1))
                torch._foreach_add_(self.acc, diff)
                self.mini_step = (self.mini_step + 1) % k
                if self.mini_step:
                    return False
                self._update(self.acc)
                torch._foreach_zero_(self.acc)
            return True
        return step

    return patched(state.Optimizer, "step", make)
