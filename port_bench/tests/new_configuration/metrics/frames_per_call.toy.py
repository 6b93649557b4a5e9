"""Frames a call of the stand-in program: its ``toy.frames`` count over its
traced ``toy.forward`` spans. None where the program keeps no spans."""

from port_bench.metrics import _spans


def read(ctx):
    recs = _spans.records()
    if recs is None:
        return None
    return _spans.per_unit(ctx, recs, "toy.forward", _spans.counted(recs, "toy.frames"))
