"""Device milliseconds a batch in the acoustic model, from the program's own
``serve.acoustic`` spans (``cli/fastpitch_infer.py::synthesize``: each
replica's ``FastPitch.infer`` and the cast of its mel to f32), over the
``serve.batch`` spans of the traced requests. CUDA events time the stream
between a span's two markers, so the time includes any idle of the device
inside the span (where the host issues slower than the device runs). None on
the CPU, or where the program keeps no spans."""

from port_bench.metrics import _spans


def read(ctx):
    recs = _spans.records()
    if recs is None:
        return None
    return _spans.per_unit(ctx, recs, "serve.batch", _spans.device_ms(recs, "serve.acoustic"))
