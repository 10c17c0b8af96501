"""The engine's host waits on the device per tick: the ``engine.syncs``
counter's count over the ticks that started in the window before the
profiled slice (each ``engine.step`` span carries its tick's count),
over those ticks. None where the program records no spans."""

LAYER = "engine (serve/engine.py::VigServeEngine.step)"
MOVES = "images_per_s"


def read(ctx):
    try:
        from repro_torch import spans
    except ImportError:
        return None
    w = ctx.window
    until = w.end if w.host_until is None else w.host_until
    ticks = spans.RECORDER.ticks(int(w.start * 1e9), int(until * 1e9))
    if not ticks:
        return None
    return sum(t.attrs["syncs"] for t in ticks) / len(ticks)
