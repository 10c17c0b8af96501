"""The device's idle share of the profiled slice: one minus the union of
its kernels, copies and sets over the slice's wall time. Listed for the
LM cell, where it moves latency_p50_ms."""

LAYER = "device (H100)"
MOVES = "latency_p50_ms"


def read(ctx):
    t = ctx.trace
    if t is None or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
