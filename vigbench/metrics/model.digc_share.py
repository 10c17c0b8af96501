"""DIGC's kernels' device time over all the device's busy time in the
profiled slice."""

from vigbench.readers import kernel_seconds

LAYER = "model (models/vig.py)"
MOVES = "images_per_s"
DIGC = r"digc_(topk|legacy)_kernel"


def read(ctx):
    if ctx.trace is None or ctx.trace["busy_s"] <= 0:
        return None
    seconds, launches = kernel_seconds(ctx, DIGC)
    if launches == 0:
        return None
    return 100.0 * seconds / ctx.trace["busy_s"]
