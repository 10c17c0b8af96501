"""Dynamic Image Graph Construction (port of ``repro/core/digc.py``).

The paper's Algorithm 1: for node features X (N, D), co-node features
Y (M, D), optional positional bias P (N, M), a neighbour count k and a
dilation d, return each node's dilated k nearest co-nodes under squared
euclidean distance:

    D_XY = ||x||^2 - 2 X Y^T + ||y||^2  (+ P)
    I'   = argsort(D_XY)[:, :k*d]
    I    = I'[:, ::d]

Inputs may be (B, N, D) / (B, M, D) or (N, D) / (M, D) (promoted to B=1,
outputs squeezed back). ``digc`` is the public entry: a lookup into the
GraphBuilder registry. This module registers the ``reference`` and
``blocked`` tiers; ``kernels/ops.py`` registers the ``cuda`` tier.

``digc(..., state=, state_key=)`` is the functional form: it threads a
``core.state.DigcState`` through the call and returns it updated. Around
every stateful builder (``blocked``, ``cluster``) sits the drift-gated
stale-graph reuse gate (DESIGN.md §12): when a row's features drifted
less than ``drift_tau`` since its cached graph was built, and the graph
is younger than ``max_stale`` gated calls, the cached graph is served
and the build skipped. Where the JAX package branches with ``lax.cond``
inside one compiled program, the port branches in Python on one
device -> host read of the gate's decision per gated call
(``gate_reads()`` counts them) when it runs eagerly. While the current
stream is capturing a CUDA graph it reads nothing: it builds every row
and keeps the reused rows' cached graph with a per-row select, which
gives the same outputs. The ``overlap`` policy's refresh build runs on
the current stream, or, given a ``RefreshFork`` (``digc(refresh=)``), on
the card's side stream until the caller joins the fork
(``models.vig.grapher_block`` forks and joins around its MRConv and FFN).

``digc(fault_plan=)`` passes the node features through the plan's
``digc.x`` site (``core/faults.py``) in eager calls; it is bypassed
while the stream is capturing. Not ported: the eager ``cache=`` shim.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.core.builder import (
    REUSE_KNOBS,
    DigcSpec,
    GraphBuilder,
    available_impls,
    get_builder,
    promote_batch,
    register,
    resolve_spec,
    reuse_params,
)
from repro_torch.core.engine import live_mask, stream_topk

# Large-but-finite sentinel: inf would give nan under (inf - inf) when a
# positional bias is added to a masked lane.
BIG = float(1e30)


def pairwise_sq_dists(x: torch.Tensor, y: torch.Tensor,
                      pos_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Squared-euclidean distance matrix (Algorithm 1 lines 3-7):
    x (..., N, D), y (..., M, D) -> (..., N, M) in fp32."""
    x = x.float()
    y = y.float()
    inner = -2.0 * (x @ y.transpose(-1, -2))
    sq_x = (x * x).sum(-1).unsqueeze(-1)
    sq_y = (y * y).sum(-1).unsqueeze(-2)
    d = inner + sq_x + sq_y
    if pos_bias is not None:
        d = d + pos_bias
    return d


def dilate(idx_sorted: torch.Tensor, dilation: int) -> torch.Tensor:
    """Neighbour Selection Module: every d-th entry of the top k*d list."""
    if dilation == 1:
        return idx_sorted
    return idx_sorted[..., ::dilation].contiguous()


def digc_reference(
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    *,
    k: int,
    dilation: int = 1,
    pos_bias: Optional[torch.Tensor] = None,
    return_dists: bool = False,
    causal: bool = False,
    m_valid: Optional[torch.Tensor] = None,
):
    """Algorithm 1 verbatim (materializes the full distance matrix).

    Entries with distance >= BIG/2 are placeholders (causally excluded or
    masked); consumers mask on the distance. ``m_valid`` ((M,) or (B, M)
    bool) BIG-masks pad co-node columns. Ties go to the lowest index.
    """
    x3, y3, p3, squeeze = promote_batch(x, y, pos_bias)
    kd = k * dilation
    _, n, _ = x3.shape
    m = y3.shape[1]
    if kd > m:
        raise ValueError(f"k*dilation={kd} exceeds number of co-nodes M={m}")
    d_xy = pairwise_sq_dists(x3, y3, p3)
    if m_valid is not None:
        mask = live_mask(m_valid, d_xy.device)
        mask = mask[None, None, :] if mask.ndim == 1 else mask[:, None, :]
        d_xy = torch.where(mask, d_xy, BIG)
    if causal:
        rows = torch.arange(n, device=d_xy.device)[:, None]
        cols = torch.arange(m, device=d_xy.device)[None, :]
        d_xy = torch.where((cols <= rows)[None], d_xy, BIG)
    dist, idx = torch.sort(d_xy, dim=-1, stable=True)
    idx = dilate(idx[..., :kd].to(torch.int32), dilation)
    dist = dilate(dist[..., :kd], dilation)
    if squeeze:
        idx, dist = idx[0], dist[0]
    if return_dists:
        return idx, dist
    return idx


def digc_blocked(
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    *,
    k: int,
    dilation: int = 1,
    pos_bias: Optional[torch.Tensor] = None,
    block_m: int = 256,
    block_n: Optional[int] = None,
    merge: Optional[str] = None,
    fuse_norms: bool = False,
    mxu_bf16: bool = False,
    sq_y: Optional[torch.Tensor] = None,
    return_dists: bool = False,
    causal: bool = False,
    group_w: Optional[int] = None,
    m_valid: Optional[torch.Tensor] = None,
):
    """Streaming DIGC through the engine (``core/engine.py``): distance
    tile -> local selection -> global merge -> dilated selection, with
    live memory O(B * block_n * block_m). ``merge`` is "select" (default)
    or "topk" (exact) or "packed" (tie-tolerant); ``fuse_norms`` and
    ``mxu_bf16`` are tie-tolerant too."""
    x3, y3, p3, squeeze = promote_batch(x, y, pos_bias)
    kd = k * dilation
    dist, idx = stream_topk(
        x3, None if y is None else y3, p3, kd=kd, block_m=block_m,
        block_n=block_n, merge=merge, fuse_norms=fuse_norms,
        mxu_bf16=mxu_bf16, causal=causal, sq_y=sq_y, group_w=group_w,
        m_valid=m_valid,
    )
    idx = dilate(idx, dilation)
    dist = dilate(dist, dilation)
    if squeeze:
        idx, dist = idx[0], dist[0]
    if return_dists:
        return idx, dist
    return idx


# --------------------------------------------------------------------------
# Drift-gated stale-graph reuse (DESIGN.md §12).
#
# The graph index is a cached, versioned artifact in the DigcStateEntry
# (graph_idx/graph_dist, the graph_snap drift snapshot and the graph_age
# staleness counter). The gate wraps any supports_state builder's build,
# per batch row, so co-batched tenants gate independently.

# Device -> host reads the gate made to decide a branch in this process.
gate_host_reads = 0


def gate_reads() -> int:
    """Device -> host reads the reuse gate made to pick its branch (one
    per gated call; the JAX package decides inside its program)."""
    return gate_host_reads


def reset_gate_reads() -> None:
    global gate_host_reads
    gate_host_reads = 0


def capturing(t: torch.Tensor) -> bool:
    """True while ``t``'s device's current stream is capturing a CUDA
    graph: no host read, no host-side fault site."""
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def _all_rows(flags: torch.Tensor) -> bool:
    """``flags.all()`` read on the host: the gate's one sync per call."""
    global gate_host_reads
    gate_host_reads += 1
    return bool(flags.all())


def drift_stat(x: torch.Tensor) -> torch.Tensor:
    """The per-row feature statistic the reuse gate compares: mean |x|^2
    over nodes and channels, (B, N, D) -> (B,) float32. Summed in another
    order than XLA's, so it differs from the JAX package's by ulps."""
    return x.float().square().mean(dim=(1, 2))


def _mix_rows(sel_row: torch.Tensor, kept, built):
    """Per-row select: ``sel_row`` (B,) True keeps ``kept``'s row. None
    passes ``built`` through."""
    if kept is None or built is None:
        return built
    sel = sel_row.reshape(sel_row.shape + (1,) * (built.ndim - 1))
    return torch.where(sel, kept, built)


def _stateful_build(builder, x3, y_arg, p3, spec, entry, m_valid=None):
    kw = {} if m_valid is None else {"m_valid": m_valid}
    return builder.build(x3, y_arg, p3, spec, state_entry=entry, **kw)


def _reuse_build(builder, x3, y_arg, p3, spec, entry, *, reuse_first,
                 m_valid=None, refresh=None):
    """The drift-gated reuse path around a stateful builder's build.

    Returns (idx, dist, new_entry). It is the plain stateful build (bit
    for bit ``reuse="off"``) whenever the policy cannot engage: no
    cached-graph buffers in the entry, a cached shape from another
    workload, or ``drift_tau == 0`` under ``layer`` / ``tick`` (a zero
    threshold admits no drift, including none at all).
    """
    policy, tau, max_stale = reuse_params(spec)
    b, n, _ = x3.shape
    if (policy is None or entry.graph_idx is None
            or tuple(entry.graph_idx.shape) != (b, n, spec.k)):
        return _stateful_build(builder, x3, y_arg, p3, spec, entry, m_valid)
    if policy in ("layer", "tick") and tau == 0.0:
        return _stateful_build(builder, x3, y_arg, p3, spec, entry, m_valid)

    valid = (entry.row_warm if entry.row_step is not None
             else entry.warm.expand(b))
    stat = drift_stat(x3)
    if policy == "overlap":
        return _overlap_build(builder, x3, y_arg, p3, spec, entry,
                              valid=valid, stat=stat, m_valid=m_valid,
                              refresh=refresh)

    drift = (stat - entry.graph_snap).abs() / entry.graph_snap.abs().clamp_min(1e-9)
    if policy == "tick" and not reuse_first:
        # Within a tick, calls after the stage's gated first one reuse
        # what that call left, without aging: staleness counts ticks.
        reuse_row = valid
        age_inc = 0
    else:
        reuse_row = valid & (entry.graph_age < max_stale) & (drift < tau)
        age_inc = 1

    # All rows reuse: the serving steady state, no distance compute. A
    # captured graph cannot read the decision: it takes the mixed branch,
    # whose reused rows carry exactly what this branch returns.
    if not capturing(x3) and _all_rows(reuse_row):
        return (entry.graph_idx, entry.graph_dist,
                entry.bump(graph_age=entry.graph_age + age_inc))

    f_idx, f_dist, built = _stateful_build(builder, x3, y_arg, p3, spec,
                                           entry, m_valid)
    idx = _mix_rows(reuse_row, entry.graph_idx, f_idx)
    dist = _mix_rows(reuse_row, entry.graph_dist, f_dist)
    # A reused row carries exactly the builder state its solo replay
    # (which never built) would: keep its centroids and norms.
    return idx, dist, dataclasses.replace(
        built,
        centroids=_mix_rows(reuse_row, entry.centroids, built.centroids),
        sq_y=_mix_rows(reuse_row, entry.sq_y, built.sq_y),
        graph_idx=idx,
        graph_dist=dist,
        graph_snap=torch.where(reuse_row, entry.graph_snap, stat),
        graph_age=torch.where(reuse_row, entry.graph_age + age_inc,
                              torch.zeros_like(entry.graph_age)),
    )


@functools.cache
def _side_stream(device: torch.device):
    """The card's stream for ``overlap`` refresh builds."""
    return torch.cuda.Stream(device)


class RefreshFork:
    """The ``overlap`` refresh builds of the ``digc(refresh=)`` calls given
    this fork: each runs on the card's side stream after the work queued
    so far on the current stream, and ``join()`` makes the current stream
    wait for them. The caller works with the served graph meanwhile and
    joins before it reads the returned state (a CUDA graph's capture must
    join every fork before it ends). On the CPU a refresh runs in place.

    Until the join the fork holds each refresh's inputs, so the allocator
    cannot hand their memory to the current stream while the refresh may
    still read them. The refresh's own tensors come from the side
    stream's pool, whose every allocation follows a wait on the current
    stream."""

    def __init__(self):
        self._device = None
        self._held: list = []

    def run(self, x3: torch.Tensor, fn, inputs: list):
        """``fn()`` on the side stream (in place on the CPU)."""
        if not x3.is_cuda:
            return fn()
        side = _side_stream(x3.device)
        side.wait_stream(torch.cuda.current_stream(x3.device))
        with torch.cuda.stream(side):
            out = fn()
        self._device = x3.device
        self._held.append(inputs)
        return out

    def join(self) -> None:
        if self._held:
            torch.cuda.current_stream(self._device).wait_stream(
                _side_stream(self._device))
            self._held.clear()


def _overlap_build(builder, x3, y_arg, p3, spec, entry, *, valid, stat,
                   m_valid=None, refresh=None):
    """Double-buffered overlap: warm rows are served the cached (one call
    stale) graph unconditionally, and the refresh build flows only into
    the returned entry (the next call's cache). Cold rows take a build in
    the mixed branch (a second build that call, cold only; under capture
    every row takes it and warm rows keep the cached graph). The refresh
    runs after the served graph is selected: on the current stream, or
    through ``refresh`` (a ``RefreshFork``) on the card's side stream."""
    if not capturing(x3) and _all_rows(valid):
        idx, dist = entry.graph_idx, entry.graph_dist
    else:
        m_idx, m_dist, _ = _stateful_build(builder, x3, y_arg, p3, spec,
                                           entry, m_valid)
        idx = _mix_rows(valid, entry.graph_idx, m_idx)
        dist = _mix_rows(valid, entry.graph_dist, m_dist)
    def build():
        return _stateful_build(builder, x3, y_arg, p3, spec, entry, m_valid)

    f_idx, f_dist, built = (build() if refresh is None else refresh.run(
        x3, build, [x3, y_arg, p3, m_valid, entry]))
    return idx, dist, dataclasses.replace(
        built, graph_idx=f_idx, graph_dist=f_dist, graph_snap=stat,
        graph_age=torch.zeros_like(entry.graph_age))


def digc(
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    *,
    spec: Optional[DigcSpec] = None,
    k: Optional[int] = None,
    dilation: Optional[int] = None,
    impl: Optional[str] = None,
    pos_bias: Optional[torch.Tensor] = None,
    return_dists: bool = False,
    causal: Optional[bool] = None,
    state=None,
    state_key: Optional[str] = None,
    reuse_first: bool = True,
    fault_plan=None,
    refresh: Optional[RefreshFork] = None,
    m_valid: Optional[torch.Tensor] = None,
    **knobs,
):
    """Public DIGC API: a GraphBuilder-registry lookup.

    Pass a full ``spec=DigcSpec(...)`` or the keywords (``k``,
    ``dilation``, ``impl``, plus builder knobs); knobs the selected
    builder does not accept raise. Accepts (N, D) or (B, N, D) nodes;
    outputs match the input rank. ``y=None`` is the self-graph.
    ``m_valid`` ((M,) or (B, M) bool) marks live co-nodes and raises for
    builders without ``supports_pad``.

    ``state`` / ``state_key`` (a ``core.state.DigcState`` and the key of
    this call's entry) select the functional form: the call returns
    ``(idx[, dist], new_state)``. A stateful builder reads its entry and
    returns an updated one, through the reuse gate when the spec carries
    a ``reuse`` policy and the entry cached-graph buffers;
    ``reuse_first=False`` marks a later call of the same forward pass
    (the ``tick`` policy reuses those without re-gating). A stateless
    builder, or a state with no entry for the key, passes the state
    through unchanged. ``refresh`` (a ``RefreshFork``) moves the
    ``overlap`` policy's refresh build onto the card's side stream: call
    ``refresh.join()`` before reading the returned state.

    ``fault_plan`` (a ``core.faults.FaultPlan``) passes the node features
    through the plan's ``digc.x`` site before construction: a no-op when
    None, and bypassed while the stream is capturing a CUDA graph.
    """
    spec = resolve_spec(
        spec, impl=impl, k=k, dilation=dilation, causal=causal, **knobs
    )
    builder = get_builder(spec.impl)
    builder.validate(spec, has_pos_bias=pos_bias is not None)
    if m_valid is not None and not builder.supports_pad:
        raise ValueError(
            f"DIGC impl {spec.impl!r} does not support pad-node masking "
            f"(m_valid); pad-capable impls: {_pad_capable()}"
        )
    if fault_plan is not None and not capturing(x):
        fired = fault_plan.fire("digc.x", value=x, impl=spec.impl)
        if fired is not x:
            x = torch.as_tensor(fired, device=x.device)
    x3, y3, p3, squeeze = promote_batch(x, y, pos_bias)
    y_arg = None if y is None else y3
    kw = {} if m_valid is None else {"m_valid": m_valid}
    entry = state.get(state_key) if state is not None else None
    if entry is not None and builder.supports_state:
        idx, dist, new_entry = _reuse_build(
            builder, x3, y_arg, p3, spec, entry, reuse_first=reuse_first,
            m_valid=m_valid, refresh=refresh)
        state = state.set(state_key, new_entry)
    else:
        idx, dist = builder.build(x3, y_arg, p3, spec, **kw)
    if squeeze:
        idx, dist = idx[0], dist[0]
    out = (idx, dist) if return_dists else (idx,)
    if state is not None:
        return (*out, state)
    return out if return_dists else idx


def _pad_capable() -> list[str]:
    return [n for n in available_impls() if get_builder(n).supports_pad]


def _build_reference(x, y, pos_bias, spec: DigcSpec, m_valid=None):
    return digc_reference(
        x, y, k=spec.k, dilation=spec.dilation, pos_bias=pos_bias,
        causal=spec.causal, return_dists=True, m_valid=m_valid,
    )


def _build_blocked(x, y, pos_bias, spec: DigcSpec, state_entry=None,
                   m_valid=None):
    # Exact tier: no implicit norm reuse. A caller serving a frozen
    # gallery passes a state entry carrying sq_y; the norms are computed
    # on the cold call (or, with per-row counters, for the rows just
    # reset) and carried after that.
    sq_y = None
    new_entry = None
    if state_entry is not None:
        new_entry = state_entry.bump()
        if (y is not None and state_entry.sq_y is not None
                and tuple(state_entry.sq_y.shape) == tuple(y.shape[:-1])):
            warm = (state_entry.row_warm[:, None]
                    if state_entry.row_step is not None else state_entry.warm)
            sq_y = torch.where(warm, state_entry.sq_y,
                               y.float().square().sum(-1))
            new_entry = state_entry.bump(sq_y=sq_y)
    idx, dist = digc_blocked(
        x, y, k=spec.k, dilation=spec.dilation, pos_bias=pos_bias,
        causal=spec.causal, return_dists=True,
        block_m=spec.block_m if spec.block_m is not None else 256,
        block_n=spec.block_n, merge=spec.merge,
        fuse_norms=bool(spec.fuse_norms), mxu_bf16=bool(spec.mxu_bf16),
        sq_y=sq_y, group_w=spec.group_w, m_valid=m_valid,
    )
    if state_entry is not None:
        return idx, dist, new_entry
    return idx, dist


register(GraphBuilder(
    name="reference",
    build=_build_reference,
    knobs=frozenset(),
    supports_pos_bias=True,
    supports_causal=True,
    supports_pad=True,
    doc="Algorithm 1 verbatim; full distance matrix (oracle tier)",
))

register(GraphBuilder(
    name="blocked",
    build=_build_blocked,
    knobs=frozenset({
        "block_n", "block_m", "merge", "fuse_norms", "mxu_bf16", "group_w",
    }) | REUSE_KNOBS,
    supports_pos_bias=True,
    supports_causal=True,
    supports_pad=True,
    supports_state=True,  # frozen-gallery norms and the reuse gate
    doc="streaming engine: (block_n x block_m) tiles + a select | topk | "
        "packed merge",
))
