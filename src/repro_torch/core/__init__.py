# Dynamic Image Graph Construction (DIGC) in PyTorch: the spec + builder
# registry, the reference and blocked tiers and the graph ops.
# Batched-first: (B, N, D) in, (B, N, k) int32 out, with (N, D) promoted
# to B=1. The ``cuda`` tier registers from ``repro_torch.kernels.ops`` on
# first use.

from repro_torch.core.builder import (
    DEGRADATION_LADDER,
    DigcSpec,
    GraphBuilder,
    available_impls,
    degraded_spec,
    fallback_chain,
    get_builder,
    list_builders,
    promote_batch,
    register,
    resolve_spec,
)
from repro_torch.core.digc import (
    BIG,
    digc,
    digc_blocked,
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
