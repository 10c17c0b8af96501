"""Set-up: process start to the first timed request (imports, the
kernels' build, weights, image pool, warm-up ticks and their captures)."""

LAYER = None
MOVES = None


def read(ctx):
    return ctx.setup_s
