"""The whole training step's share of the card's dense bf16 peak (989
TFLOP/s): the step's FLOPs from the published widths
(``counts/<config>.py::step_flops``) times the steps completed, over the
window's seconds, in %."""

from port_bench.yardstick.bounds import BF16_PEAK


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None  # not on a device
    h = ctx.config["hifigan"]
    flops = ctx.counts.step_flops(ctx.config, h["batch_size"], h["segment_size"])
    return 100.0 * ctx.extras["steps_ok"] * flops / (ctx.extras["window_s"] * BF16_PEAK)
