"""The share of the traced documents' bf16 convs on the card that ran
channels-last (``nn/layers.py::nhwc_conv1d``): 100 × ``conv.nhwc`` /
(``conv.nhwc`` + ``conv.nchw``), a CUDA graph's replay counting what its
capture counted. None where the program keeps no spans or makes neither
count."""

from port_bench.metrics import _spans


def read(ctx):
    recs = _spans.records()
    if recs is None:
        return None
    nhwc, nchw = _spans.counted(recs, "conv.nhwc"), _spans.counted(recs, "conv.nchw")
    return 100.0 * nhwc / (nhwc + nchw) if nhwc + nchw else None
