"""The 95th percentile (nearest rank) of time to first token inside the
program: from a request's ``engine.submit`` span to the end of the
``lm.pull`` of the tick that prefilled it, when its first token reached
the host (the ``lm.prefill`` span itself ends when the prefill is
launched on the card). Over the requests submitted in the window before
the profiled slice. None where the program records no LM spans."""

from vigbench import lm_readers
from vigbench.readers import percentile

LAYER = "LM engine (serve/engine.py::ServeEngine.step)"
MOVES = "latency_p95_ms"


def read(ctx):
    held = lm_readers.held_spans()
    if not held:
        return None
    w = ctx.window
    until = int((w.end if w.host_until is None else w.host_until) * 1e9)
    since = int(w.start * 1e9)
    submitted = {s.key: s.t0 for s in held
                 if s.name == "engine.submit" and since <= s.t0 < until}
    first = {}
    for _, kids in lm_readers.ticks(held, since, until + int(1e12)):
        for pre in kids.get("lm.prefill", []):
            if pre.key in submitted and pre.key not in first:
                first[pre.key] = kids["lm.pull"][0].t1
    waits = [first[uid] - t0 for uid, t0 in submitted.items() if uid in first]
    return 1e-6 * percentile(waits, 0.95) if waits else None
