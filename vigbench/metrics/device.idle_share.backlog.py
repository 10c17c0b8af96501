"""The device's idle share of the profiled slice: one minus the union of
its kernels, copies and sets over the slice's wall time. Listed for the
backlog cells, where it moves images_per_s."""

LAYER = "device (H100)"
MOVES = "images_per_s"


def read(ctx):
    t = ctx.trace
    if t is None or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
