"""What the readers of the program's own spans and counters share: the
finished span records of the traced stretch of the window
(``neuraltexttospeech_torch/utils/profiling.py::spans``; the program records
them only while the profiler runs), their sums by name, and the units they
are divided over. A program that keeps no spans gives None, and so does
every reader."""

from __future__ import annotations


def records():
    """The program's finished spans, or None where it keeps none."""
    from neuraltexttospeech_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    recs = spans() if spans is not None else None
    return recs or None


def named(recs, name: str):
    return [r for r in recs if r.name == name]


def host_ms(recs, name: str) -> float:
    """Host ms summed over the spans called ``name``."""
    return sum(r.host_ms for r in named(recs, name))


def device_ms(recs, name: str):
    """CUDA-event ms summed over the spans called ``name``: each the stream's
    time between the span's two markers, the device's idle between them
    included; None where one has none (a run on the CPU)."""
    ms = [r.device_ms for r in named(recs, name)]
    return sum(ms) if ms and all(m is not None for m in ms) else None


def counted(recs, name: str) -> int:
    """The count ``name`` summed over every span."""
    return sum(r.counts.get(name, 0) for r in recs)


def below(recs, roots, names):
    """The spans called one of ``names`` that have one of ``roots`` among
    their ancestors (by parent ids)."""
    by_id, top = {r.id: r for r in recs}, {r.id for r in roots}

    def under(r):
        while r is not None and r.parent is not None:
            if r.parent in top:
                return True
            r = by_id.get(r.parent)
        return False

    return [r for r in recs if r.name in names and under(r)]


def per_unit(ctx, recs, unit: str, value):
    """``value`` over the traced units: requests (``unit`` None: the
    window's profiled requests) or the spans called ``unit``."""
    if value is None:
        return None
    n = ctx.extras.get("trace_units", 0) if unit is None else len(named(recs, unit))
    return value / n if n else None
