"""The share of the traced requests' bf16 convs on the card that ran
channels-last: the reader of ``nhwc_conv_pct.batch`` over the single-request
cell's traced units."""

from port_bench.metrics import _spans


def read(ctx):
    recs = _spans.records()
    if recs is None:
        return None
    nhwc, nchw = _spans.counted(recs, "conv.nhwc"), _spans.counted(recs, "conv.nchw")
    return 100.0 * nhwc / (nhwc + nchw) if nhwc + nchw else None
