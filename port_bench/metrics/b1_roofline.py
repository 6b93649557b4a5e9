"""Kernel B1's share of its roofline in the GAN step: the bound of a step's
three log-mel calls (``counts/<config>.py::b1_bound_ms``, the frozen
``logmel_bound_ms``) times the traced steps, over B1's device time in the
trace, in %."""


def read(ctx):
    t, n = ctx.trace, ctx.extras.get("trace_units", 0)
    if t is None or not n or t.seconds("B1") <= 0:
        return None
    h = ctx.config["hifigan"]
    return 100.0 * n * ctx.counts.b1_bound_ms(ctx.config, h["batch_size"], h["segment_size"]) \
        / (1e3 * t.seconds("B1"))
