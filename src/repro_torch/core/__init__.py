# Dynamic Image Graph Construction (DIGC) in PyTorch: the spec + builder
# registry, the reference and blocked tiers, the approximate cluster and
# axial tiers, the graph ops, the functional DIGC state, fault injection,
# the tuner and the cost models. Batched-first: (B, N, D) in, (B, N, k)
# int32 out, with (N, D) promoted to B=1. The ``cuda`` tier registers from
# ``repro_torch.kernels.ops`` on first use.

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
from repro_torch.core.faults import SITES, FaultError, FaultInfo, FaultPlan
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
from repro_torch.core.perfmodel import (
    FPGAConfig,
    H100Config,
    digc_flops,
    digc_hbm_bytes,
    fpga_cycles,
    fpga_latency_ms,
    h100_digc_estimate,
    vig_resolution_to_nodes,
)
from repro_torch.core.state import (
    DigcState,
    DigcStateEntry,
    state_entry,
)
from repro_torch.core.strategies import (
    axial_digc,
    cluster_digc,
    default_cluster_params,
    kmeans,
    recall_vs_exact,
)
from repro_torch.core.tuner import (
    DigcTuner,
    TileConfig,
    VigSchedule,
    autotune_spec,
    host_key,
    workload_key,
)
