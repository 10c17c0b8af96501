"""The MRConv kernel's share of its roofline over the profiled ticks:
the least time of every call (``shapes.mrconv_least_s``: x, y and the
indices read once and the aggregate written once at the HBM rate, or a
subtract and a max per (node, neighbour, feature) at the CUDA cores'
fp32 peak) over the measured device time of the kernels."""

from vigbench import shapes
from vigbench.readers import roofline

LAYER = "kernels (kernels/csrc/mrconv.cu)"
MOVES = "images_per_s"
KERNEL = r"mrconv_kernel"


def read(ctx):
    return roofline(ctx, KERNEL, shapes.mrconv_calls, shapes.mrconv_least_s)
