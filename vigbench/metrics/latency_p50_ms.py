"""The 50th percentile (nearest rank) of request latency over every
request due in the window: from its due time to the return of the
``step()`` that brought its logits to the host. A failed request never
came and lies in the tail. Open-loop mixes only."""

from vigbench.readers import latencies_s, percentile

LAYER = None
MOVES = None


def read(ctx):
    if ctx.mix["loop"] != "open":
        return None
    return 1e3 * percentile(latencies_s(ctx), 0.50)
