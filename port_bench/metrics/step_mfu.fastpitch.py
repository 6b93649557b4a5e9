"""The whole FastPitch training micro-step's share of the card's dense bf16
peak (989 TFLOP/s): each completed micro-step's FLOPs at its batch's padded
shapes (``counts/<config>.py::train_flops``), summed over the window, over
the window's seconds, in %."""

from port_bench.yardstick.bounds import BF16_PEAK


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None  # not on a device
    flops = 0
    for i in ctx.extras["done"]:
        batch, frames, tokens = ctx.extras["shapes"][i][0]
        flops += ctx.counts.train_flops(ctx.config, batch, tokens, frames)
    return 100.0 * flops / (ctx.extras["window_s"] * BF16_PEAK)
