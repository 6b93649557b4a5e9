"""Device milliseconds of the HiFi-GAN generator's forward a batch, from
CUDA events recorded by a forward pre-hook and a forward hook on the
program's generator in the traced run."""


def read(ctx):
    ms = ctx.extras.get("vocoder_ms") or []
    return sum(ms) / len(ms) if ms else None
