"""The decode steps' share of the chip's memory bandwidth: the bytes
each step needs (``lm_shapes.decode_bytes``: the weights outside the
experts, the experts its rows select, their cache rows) over the step's
time on the card (its ``lm.decode`` span's ``device_ms``, by CUDA
events), summed over the ticks of the window before the profiled slice,
over 3.35 TB/s. None where the program records no LM spans."""

from vigbench import lm_readers, lm_shapes

LAYER = "LM engine (serve/engine.py::ServeEngine.step)"
MOVES = "latency_p50_ms"


def read(ctx):
    moved, seconds = 0.0, 0.0
    for _, kids in lm_readers.host_ticks(ctx):
        for dec in kids.get("lm.decode", []):
            a = lm_readers.attrs(dec)
            moved += lm_shapes.decode_bytes(ctx.cfg, len(a["rows"]), a["kv"])
            seconds += 1e-3 * a["device_ms"]
    if seconds <= 0:
        return None
    return 100.0 * moved / seconds / lm_shapes.PEAK_HBM_BYTES
