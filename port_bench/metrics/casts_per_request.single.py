"""Tensors the program casts to the compute type a request, the
``precision.casts`` count of ``nn/precision.py::promote`` (each layer call's
f32 weight, bias and input cast to bf16), over the traced requests. None
where the program keeps no spans."""

from port_bench.metrics import _spans


def read(ctx):
    recs = _spans.records()
    if recs is None:
        return None
    return _spans.per_unit(ctx, recs, None, _spans.counted(recs, "precision.casts"))
