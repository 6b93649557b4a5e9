"""Kernel B2's share of its roofline in the GAN step: the bound of a step's
90 B2 calls (``counts/<config>.py::b2_bound_ms``, the frozen
``tap_dots_bound_ms`` over ``msd_tap_shapes``) times the traced steps, over
the device time of B2's kernels (main, weight prologue, split sums) in the
trace, in %."""


def read(ctx):
    t, n = ctx.trace, ctx.extras.get("trace_units", 0)
    if t is None or not n:
        return None
    seconds = t.seconds("B2 f32") + t.seconds("B2 bf16")
    if seconds <= 0:
        return None
    h = ctx.config["hifigan"]
    return 100.0 * n * ctx.counts.b2_bound_ms(ctx.config, h["batch_size"], h["segment_size"]) \
        / (1e3 * seconds)
