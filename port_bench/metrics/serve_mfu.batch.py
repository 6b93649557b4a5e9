"""The served work's share of the card's dense bf16 peak (989 TFLOP/s, the
H100 SXM data sheet): the FLOPs of FastPitch's inference and the generator
at every served utterance's own length (``counts/<config>.py``) over the
window's seconds, in %."""

from port_bench.yardstick.bounds import BF16_PEAK


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None  # not on a device
    flops = sum(ctx.counts.utterance_flops(ctx.config, t, f)
                for r in ctx.extras["records"] for t, f in zip(r["tokens"], r["frames"]))
    return 100.0 * flops / (ctx.extras["window_s"] * BF16_PEAK)
