"""The median time of a decode step as the host sees it: from the start
of a tick's ``lm.decode`` span to the end of its ``lm.pull`` (the step's
launch, its work on the card and the read of its tokens), over the ticks
of the window before the profiled slice that prefilled nothing. None
where the program records no LM spans."""

from vigbench import lm_readers
from vigbench.readers import percentile

LAYER = "LM engine (serve/engine.py::ServeEngine.step)"
MOVES = "latency_p50_ms"


def read(ctx):
    steps = [kids["lm.pull"][0].t1 - kids["lm.decode"][0].t0
             for _, kids in lm_readers.host_ticks(ctx)
             if "lm.decode" in kids and "lm.prefill" not in kids]
    return 1e-6 * percentile(steps, 0.5) if steps else None
