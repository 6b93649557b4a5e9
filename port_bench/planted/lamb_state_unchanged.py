from port_bench.faults import patched


def lamb_state_unchanged():
    """The port's optimizer (``train/state.py``) takes its gradients and
    never updates: every parameter and moment stays as it was."""
    from neuraltexttospeech_torch.train import state

    return patched(state.Optimizer, "_update", lambda orig: lambda self, grads: None)
