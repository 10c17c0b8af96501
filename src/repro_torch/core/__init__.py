# Dynamic Image Graph Construction (DIGC) in PyTorch: the spec + builder
# registry, the reference tier and the graph ops. Batched-first: (B, N, D)
# in, (B, N, k) int32 out, with (N, D) promoted to B=1. The ``cuda`` tier
# registers from ``repro_torch.kernels.ops`` on first use.

from repro_torch.core.builder import (
    DigcSpec,
    GraphBuilder,
    available_impls,
    get_builder,
    promote_batch,
    register,
    resolve_spec,
)
from repro_torch.core.digc import (
    BIG,
    digc,
    digc_reference,
    dilate,
    pairwise_sq_dists,
)
from repro_torch.core.graph import (
    AGGREGATORS,
    degree_histogram,
    edge_list,
    grid_pos_bias,
    knn_gather,
    mean_aggregate,
    mr_aggregate,
    sum_aggregate,
)
