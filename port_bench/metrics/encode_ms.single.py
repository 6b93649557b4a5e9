"""Host milliseconds a request in the program's text front end, from its own
``text.encode`` spans (``TextProcessing.encode_text``), over the traced
requests: the in-program twin of ``frontend_ms.single``. None where the
program keeps no spans."""

from port_bench.metrics import _spans


def read(ctx):
    recs = _spans.records()
    if recs is None:
        return None
    return _spans.per_unit(ctx, recs, None, _spans.host_ms(recs, "text.encode"))
