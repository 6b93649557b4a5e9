"""The MAS kernel's share of its roofline in FastPitch training: the frozen
``mas_bound_ms`` (``yardstick/bounds.py``) at each traced micro-step's own
``[B, T_mel, T_text]`` and mel lengths, summed, over the device time of the
trace's ``MAS`` records (``mas_kernel``), in %."""

from port_bench.yardstick.bounds import mas_bound_ms


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.extras.get("traced") or t.seconds("MAS") <= 0:
        return None
    bound_ms = 0.0
    for i in ctx.extras["traced"]:
        (batch, frames, tokens), mel_lens = ctx.extras["shapes"][i]
        bound_ms += mas_bound_ms(batch, frames, tokens, mel_lens)[0]
    return 100.0 * bound_ms / (1e3 * t.seconds("MAS"))
