from port_bench.faults import patched


def small_leaves_unchanged():
    """Every optimizer step leaves the one-dimensional parameters (the
    biases) as they were and steps the rest."""
    import torch

    def make(orig):
        def step(self, closure=None):
            small = [p for g in self.param_groups for p in g["params"] if p.dim() == 1]
            before = [p.detach().clone() for p in small]
            out = orig(self, closure)
            with torch.no_grad():
                for p, b in zip(small, before):
                    p.copy_(b)
            return out
        return step

    return patched(torch.optim.Adam, "step", make)
