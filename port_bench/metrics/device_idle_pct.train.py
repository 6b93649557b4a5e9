"""Share of the traced stretch of the window in which no operation ran on
the device: 1 − (union of the device records' intervals) / (the stretch's
length on the host's clock), in %."""


def read(ctx):
    t = ctx.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
