"""The median host time of an engine tick: each ``engine.step`` span the
program recorded (``repro_torch.spans``) less its waits on the device
(its ``engine.screen.wait`` and ``engine.pull`` spans), over the ticks
that started in the window before the profiled slice. None where the
program records no spans. Listed for the backlog cells, where it moves
images_per_s."""

from vigbench.readers import percentile

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
    return 1e-6 * percentile([t.t1 - t.t0 - t.wait_ns for t in ticks], 0.5)
