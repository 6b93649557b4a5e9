"""Host milliseconds from a training step's call to its return, before any
synchronisation: the time to issue the step, over every step of the window."""


def read(ctx):
    s = ctx.extras["issue_s"]
    return 1e3 * sum(s) / len(s) if s else None
