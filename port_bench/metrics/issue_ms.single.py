"""Host milliseconds a request spends issuing work, from the program's own
spans: each ``serve.batch`` span (``cli/fastpitch_infer.py::synthesize``)
less the ``serve.wait`` and ``serve.to_host`` spans below it, where the host
waits for the device (the lengths' and the outputs' reads), over the traced
requests. None where the program keeps no spans."""

from port_bench.metrics import _spans


def read(ctx):
    recs = _spans.records()
    if recs is None:
        return None
    batches = _spans.named(recs, "serve.batch")
    if not batches:
        return None
    waits = _spans.below(recs, batches, ("serve.wait", "serve.to_host"))
    ms = sum(b.host_ms for b in batches) - sum(r.host_ms for r in waits)
    return _spans.per_unit(ctx, recs, None, ms)
