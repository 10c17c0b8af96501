"""The share of the ticks' lanes that were padding: over the window's
ticks (those before the profiled slice, in a traced run), the bucket
each tick ran (the engine's ``last_bucket``) less the requests it
served, over the buckets' lanes."""

LAYER = "engine (serve/engine.py::VigServeEngine.step)"
MOVES = "latency_p95_ms"


def read(ctx):
    ticks = [t for t in ctx.window.host_ticks() if t[3] is not None]
    lanes = sum(bucket for *_, bucket, _ in ticks)
    if lanes == 0:
        return None
    return 100.0 * (lanes - sum(served for _, _, served, *_ in ticks)) / lanes
