from port_bench.faults import patched


def toy_half_batch():
    """The stand-in program's layers leave out the second half of each batch
    (zeros there)."""
    import torch

    def make(orig):
        def forward(self, x):
            out = orig(self, x).clone()
            out[(out.shape[0] + 1) // 2:] = 0.0
            return out
        return forward

    return patched(torch.nn.Linear, "forward", make)
