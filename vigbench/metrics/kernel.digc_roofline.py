"""The DIGC kernel's share of its roofline over the profiled ticks: the
least time of every call (``shapes.digc_least_s``: 2 b n m d operations
at the TF32 tensor-core peak, or x and y read once and the sorted
top-(k d) indices and distances written once at the HBM rate) over the
measured device time of the kernels. The top-k selection is not
counted, so the share reads low."""

from vigbench import shapes
from vigbench.readers import roofline

LAYER = "kernels (kernels/csrc/digc_topk.cu)"
MOVES = "images_per_s"
KERNEL = r"digc_(topk|legacy)_kernel"


def read(ctx):
    return roofline(ctx, KERNEL, shapes.digc_calls, shapes.digc_least_s)
