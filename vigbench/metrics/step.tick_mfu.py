"""The whole step's share of the chip's peak: the model's FLOPs per
image (every GEMM plus DIGC's distance products,
``shapes.model_flops_per_image``) times the live images of the profiled
ticks, over the slice's seconds, over the TF32 tensor-core peak."""

from vigbench import shapes

LAYER = "whole step"
MOVES = "images_per_s"


def read(ctx):
    t = ctx.trace
    if t is None or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    images = sum(live for _, live in t["ticks"])
    flops = shapes.model_flops_per_image(ctx.cfg) * images
    return 100.0 * flops / t["window_s"] / shapes.PEAK_TF32_FLOPS
