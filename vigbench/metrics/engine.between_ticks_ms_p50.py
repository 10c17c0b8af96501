"""The median host time between two engine ticks: from one ``engine.step``
span's end to the next one's start (the serving loop, its
``VigServeEngine.submit`` calls among it), the gap before each tick that
started in the window before the profiled slice (the first one's gap
reaches back to set-up's last tick). None where the program records no
spans."""

from vigbench.readers import percentile

LAYER = "caller (serving loop and VigServeEngine.submit)"
MOVES = "images_per_s"


def read(ctx):
    try:
        from repro_torch import spans
    except ImportError:
        return None
    w = ctx.window
    until = w.end if w.host_until is None else w.host_until
    ticks = spans.RECORDER.ticks(0, int(until * 1e9))
    since = int(w.start * 1e9)
    gaps = [b.t0 - a.t1 for a, b in zip(ticks, ticks[1:]) if b.t0 >= since]
    return 1e-6 * percentile(gaps, 0.5) if gaps else None
