"""The share of the traced requests' FastPitch and generator calls that
replayed a CUDA graph (``utils/graphs.py``): 100 × ``graph.replay`` /
(``graph.replay`` + ``graph.eager``), a call that captured its shape
counting in neither. None where the program keeps no spans or makes
neither count."""

from port_bench.metrics import _spans


def read(ctx):
    recs = _spans.records()
    if recs is None:
        return None
    replay, eager = _spans.counted(recs, "graph.replay"), _spans.counted(recs, "graph.eager")
    return 100.0 * replay / (replay + eager) if replay + eager else None
