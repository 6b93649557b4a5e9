"""Seconds of training audio that the window's completed FastPitch
micro-steps consumed (each its utterances' unpadded mel frames · hop / rate)
over the window's seconds on the host's clock: the rate a training run
sees. The host issues every micro-step, so its speed, which differs between
processes, sets this rate."""


def read(ctx):
    ex = ctx.extras
    if not ex.get("done") or ex.get("window_s", 0) <= 0:
        return None
    return sum(ex["audio_s"][i] for i in ex["done"]) / ex["window_s"]
