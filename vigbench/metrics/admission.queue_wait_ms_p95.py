"""The 95th percentile (nearest rank) of a request's wait in the queue:
from its due time to the start of the ``step()`` that served it, over
the requests due in the window (before the profiled slice, in a traced
run) that were served. Open-loop mixes only."""

from vigbench.readers import percentile

LAYER = "admission (the engine's _select_cell, serve/sched.py)"
MOVES = "latency_p95_ms"


def read(ctx):
    if ctx.mix["loop"] != "open":
        return None
    waits = [r.start - r.due for r in ctx.window.host_requests()
             if not r.failed and r.start is not None]
    return 1e3 * percentile(waits, 0.95) if waits else None
