from port_bench.faults import patched


def dropout_skipped():
    """The predictors' dropout (``nn/layers.py::ConvReLUNorm``) applies no
    mask and draws none: each returns its input."""
    # nn/transformer.py binds layers.dropout when it is first imported: import it
    # first, so that only the predictors' calls meet the fault
    from neuraltexttospeech_torch.nn import layers, transformer  # noqa: F401

    return patched(layers, "dropout", lambda orig: lambda x, p, generator=None, **kw: x)
