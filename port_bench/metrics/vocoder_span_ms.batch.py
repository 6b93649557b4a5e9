"""Device milliseconds a batch in the vocoder, from the program's own
``serve.vocoder`` spans (``cli/hifigan_infer.py::vocode_replicas``: each
replica's ``vocode`` call), over the ``serve.batch`` spans of the traced
requests: the in-program twin of ``vocoder_ms.batch``. CUDA events time the
stream between a span's two markers, so the time includes any idle of the
device inside the span. None on the CPU, or where the program keeps no
spans."""

from port_bench.metrics import _spans


def read(ctx):
    recs = _spans.records()
    if recs is None:
        return None
    return _spans.per_unit(ctx, recs, "serve.batch", _spans.device_ms(recs, "serve.vocoder"))
