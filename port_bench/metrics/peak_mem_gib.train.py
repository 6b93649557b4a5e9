"""The allocator's peak over the training window
(``torch.cuda.max_memory_allocated`` after a reset at the window's start),
in GiB."""


def read(ctx):
    peak = ctx.extras.get("peak_bytes", 0)
    return peak / 2 ** 30 if peak else None
