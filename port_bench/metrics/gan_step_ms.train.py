"""Host milliseconds a GAN step, from the program's own ``gan.step`` spans
(``models/hifigan_gan.py::HiFiGANTrainer.train_step``, no synchronise), over
the traced steps: the in-program twin of ``host_issue_ms.train``, which
times every step of the window with the profiler off. None where the program
keeps no spans."""

from port_bench.metrics import _spans


def read(ctx):
    recs = _spans.records()
    if recs is None:
        return None
    return _spans.per_unit(ctx, recs, "gan.step", _spans.host_ms(recs, "gan.step"))
