"""The median host time of one engine tick in the window: the
benchmark's span around each ``step()``, which ends with the logits on
the host; in a traced run, the ticks before the profiled slice."""

from vigbench.readers import percentile

LAYER = "engine (serve/engine.py::VigServeEngine.step)"
MOVES = "latency_p95_ms"


def read(ctx):
    spans = [t1 - t0 for t0, t1, served, *_ in ctx.window.host_ticks() if served]
    return 1e3 * percentile(spans, 0.5) if spans else None
