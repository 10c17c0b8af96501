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
GraphBuilder registry. This module registers the ``reference`` tier;
``kernels/ops.py`` registers the ``cuda`` tier. The stateful paths of the
JAX entry (``state=``, ``cache=``, ``fault_plan=``) are not ported yet.
"""

from __future__ import annotations

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
)
from repro_torch.core.engine import stream_topk

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
        mask = torch.as_tensor(m_valid, dtype=torch.bool, device=d_xy.device)
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
    x3, y3, p3, squeeze = promote_batch(x, y, pos_bias)
    kw = {} if m_valid is None else {"m_valid": m_valid}
    idx, dist = builder.build(x3, None if y is None else y3, p3, spec, **kw)
    if squeeze:
        idx, dist = idx[0], dist[0]
    if return_dists:
        return idx, dist
    return idx


def _pad_capable() -> list[str]:
    return [n for n in available_impls() if get_builder(n).supports_pad]


def _build_reference(x, y, pos_bias, spec: DigcSpec, m_valid=None):
    return digc_reference(
        x, y, k=spec.k, dilation=spec.dilation, pos_bias=pos_bias,
        causal=spec.causal, return_dists=True, m_valid=m_valid,
    )


def _build_blocked(x, y, pos_bias, spec: DigcSpec, state_entry=None,
                   m_valid=None):
    reuse = sorted(f for f in REUSE_KNOBS if getattr(spec, f) is not None)
    if state_entry is not None or reuse:
        raise NotImplementedError(
            f"the blocked tier's functional state and stale-graph reuse "
            f"({reuse or 'state_entry'}) are not ported yet (ROADMAP queue 1, "
            "item 5)"
        )
    return digc_blocked(
        x, y, k=spec.k, dilation=spec.dilation, pos_bias=pos_bias,
        causal=spec.causal, return_dists=True,
        block_m=spec.block_m if spec.block_m is not None else 256,
        block_n=spec.block_n, merge=spec.merge,
        fuse_norms=bool(spec.fuse_norms), mxu_bf16=bool(spec.mxu_bf16),
        group_w=spec.group_w, m_valid=m_valid,
    )


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
    doc="streaming engine: (block_n x block_m) tiles + a select | topk | "
        "packed merge",
))
