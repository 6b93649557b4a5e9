from port_bench.faults import patched


def state_unchanged():
    """Every optimizer step leaves the parameters as they were."""
    import torch

    return patched(torch.optim.Adam, "step", lambda orig: lambda self, closure=None: None)
