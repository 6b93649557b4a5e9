"""Device records (kernels, copies, memsets) a request, in the profiler's
trace of the window's first requests."""


def read(ctx):
    t, n = ctx.trace, ctx.extras.get("trace_units", 0)
    if t is None or not n or t.launches == 0:
        return None
    return t.launches / n
