"""Weight-norm and spectral-norm computations a GAN step, the
``norms.weight_norm`` count of ``nn/norms.py`` (one each time a normalised
weight is computed), over the traced steps' ``gan.step`` spans. None where
the program keeps no spans."""

from port_bench.metrics import _spans


def read(ctx):
    recs = _spans.records()
    if recs is None:
        return None
    return _spans.per_unit(ctx, recs, "gan.step", _spans.counted(recs, "norms.weight_norm"))
