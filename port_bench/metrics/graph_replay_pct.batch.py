"""The share of the traced documents' FastPitch and generator calls that
replayed a CUDA graph: the reader of ``graph_replay_pct.single`` over the
batch cell's traced units."""

from port_bench.metrics import _spans


def read(ctx):
    recs = _spans.records()
    if recs is None:
        return None
    replay, eager = _spans.counted(recs, "graph.replay"), _spans.counted(recs, "graph.eager")
    return 100.0 * replay / (replay + eager) if replay + eager else None
