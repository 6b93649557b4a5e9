"""Host milliseconds a GAN step in its backward (``gan.backward``: the one
``backward`` of both lanes' losses), from the program's own spans, over the
traced steps' ``gan.step`` spans. None where the program keeps no spans."""

from port_bench.metrics import _spans


def read(ctx):
    recs = _spans.records()
    if recs is None:
        return None
    return _spans.per_unit(ctx, recs, "gan.step", _spans.host_ms(recs, "gan.backward"))
