"""Approximate graph-construction tiers (port of ``repro/core/strategies.py``).

Two registered GraphBuilders beside the exact tiers, batched-first:
(B, N, D) in, (B, N, k) out, with (N, D) promoted to B = 1.

  * ``cluster_digc`` -- IVF-style two-stage search (ClusterViG family):
    k-means centroids over the co-nodes, then each query searches only
    its ``n_probe`` nearest clusters. O(N (C + probe cap) D) against
    O(N M D).
  * ``axial_digc``   -- axial construction (GreedyViG family): candidates
    are the query's grid row and column. O(N (H + W) D).

Both are plain PyTorch on tensors (the JAX package computes them with
XLA products, gathers and ``lax.top_k``, outside any Pallas kernel);
their products go through ``torch.matmul``. Where JAX ``vmap``s a
per-image function, these functions take the batch axis directly.

Determinism: the k-means sums are a one-hot product (float atomics would
reorder them from run to run), the per-cluster counts an integer
``scatter_add_`` (no ``bincount``, which reads the size on the host), and
every selection a stable sort (ties to the lowest index, as
``lax.top_k``). So a captured CUDA graph gives its eager run's bits.

Warm starts: ``cluster_digc(init_centroids=, init_valid=)`` refines
carried centroids with ``warm_iters`` Lloyd iterations instead of the
cold ``kmeans_iters`` from a seeded permutation (``core/prng.py``, JAX's
``jax.random.permutation`` bit for bit). JAX picks the branch with
``lax.cond`` inside its program. Run eagerly, the port reads the flag
on the host once per call (``core.digc._all_rows``, counted by
``gate_reads()``); while a CUDA graph is being captured it reads
nothing: it builds both indexes and selects per row, which returns the
read branch's outputs bit for bit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.builder import (
    REUSE_KNOBS, DigcSpec, GraphBuilder, promote_batch, register,
)
from repro_torch.core.digc import (
    BIG, _all_rows, capturing, digc_blocked, digc_reference, dilate,
    pairwise_sq_dists,
)
from repro_torch.core.engine import select_topkd
from repro_torch.core.prng import permutation


def kmeans(y: torch.Tensor, n_clusters: int, iters: int = 5, seed: int = 0,
           init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Lloyd's iterations: y (..., M, D) -> centroids (..., C, D).

    The cold start takes the rows ``jax.random.permutation(PRNGKey(seed),
    M)[:C]``; ``init`` warm-starts from carried centroids (consecutive
    layers and requests drift slowly, so 1-2 iterations suffice)."""
    m = y.shape[-2]
    if init is None:
        cents = y[..., permutation(seed, m, y.device)[:n_clusters], :]
    else:
        cents = init.to(y.dtype)
    labels = torch.arange(n_clusters, device=y.device)
    for _ in range(iters):
        assign = pairwise_sq_dists(y, cents).argmin(dim=-1)  # (..., M)
        onehot = (assign[..., None] == labels).to(y.dtype)  # (..., M, C)
        sums = onehot.transpose(-1, -2) @ y  # (..., C, D)
        counts = onehot.sum(dim=-2)[..., None]
        cents = torch.where(counts > 0, sums / counts.clamp_min(1), cents)
    return cents


def default_cluster_params(m: int, n_clusters: Optional[int],
                           n_probe: Optional[int]) -> tuple[int, int]:
    """Workload-adaptive defaults: ~28 co-nodes per cluster, probe up to
    8 clusters."""
    if n_clusters is None:
        n_clusters = max(m // 28, 4)
    n_clusters = min(n_clusters, m)
    if n_probe is None:
        n_probe = 8
    return n_clusters, min(n_probe, n_clusters)


def _segment_ranks(labels: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its label group along the last axis,
    in original order: a stable argsort groups equal labels, the rank is
    the position minus the group start (a running max over change
    points), scattered back through the sort order. int64."""
    length = labels.shape[-1]
    order = torch.argsort(labels, dim=-1, stable=True)
    sorted_l = labels.gather(-1, order)
    pos = torch.arange(length, device=labels.device).expand_as(order)
    change = torch.cat([torch.ones_like(sorted_l[..., :1], dtype=torch.bool),
                        sorted_l[..., 1:] != sorted_l[..., :-1]], dim=-1)
    seg_start = torch.cummax(torch.where(change, pos, 0), dim=-1).values
    return torch.zeros_like(order).scatter_(-1, order, pos - seg_start)


def _cluster_index(y: torch.Tensor, *, n_clusters: int, cap: int, seed: int,
                   iters: int = 5, init_centroids: Optional[torch.Tensor] = None):
    """The IVF index of each co-node set: y (..., M, D) -> (centroids
    (..., C, D), members (..., C, cap) int64 with pad id M). Members past
    a cluster's capacity are dropped: their slot is the pad slot, which
    takes every duplicate and is cut off."""
    m = y.shape[-2]
    lead = y.shape[:-2]
    cents = kmeans(y, n_clusters, iters=iters, seed=seed, init=init_centroids)
    assign = pairwise_sq_dists(y, cents).argmin(dim=-1)  # (..., M)
    pos = _segment_ranks(assign)
    slot = torch.where(pos < cap, assign * cap + pos, n_clusters * cap)
    members = torch.full(lead + (n_clusters * cap + 1,), m, dtype=torch.int64,
                         device=y.device)
    ids = torch.arange(m, device=y.device).expand_as(slot)
    members = members.scatter_(-1, slot, ids)[..., :-1]
    return cents, members.reshape(lead + (n_clusters, cap))


def _rows(t: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Per-batch-row gather along axis 1: t (B, R, ...), ids (B, ...) ->
    t[b, ids[b, ...]]."""
    b = t.shape[0]
    batch = torch.arange(b, device=t.device).reshape((b,) + (1,) * (ids.ndim - 1))
    return t[batch, ids]


def _cluster_search(x, y, cents, members, *, kd: int, n_probe: int,
                    block_t: int = 128):
    """Dispatch-form two-stage search: x (B, N, D), y (B, M, D), cents
    (B, C, D), members (B, C, cap) -> (idx (B, N, kd) int64, dist).

    Each (query, probe-slot) pair takes a slot in its target cluster's
    block-aligned segment (the MoE group-GEMM layout), so the dispatch
    holds N probe + C block_t rows and no query is dropped; each
    block_t-row block belongs to one cluster and runs one dense
    (block_t x D) @ (D x cap) product against its member features. The
    query norm is added back at the end (rank-invariant).

    Lanes with no finite candidate left (the probed clusters hold fewer
    than kd members) keep distance BIG and read column 0 of the
    candidate list, as the JAX package's extraction does. A pad id M
    there (an empty nearest cluster) is clamped to M - 1, the row JAX's
    gather reads for it."""
    b, n, d = x.shape
    m = y.shape[1]
    n_clusters, cap = members.shape[1:]
    dev = x.device
    y_pad = torch.cat([y, y.new_zeros(b, 1, d)], dim=1)
    sq_y = torch.cat([y.float().square().sum(-1),
                      torch.full((b, 1), BIG, device=dev)], dim=1)
    cluster_feats = _rows(y_pad, members)  # (B, C, cap, D)
    sq_members = _rows(sq_y, members)  # (B, C, cap); BIG on member pads

    # Stage 1: the nearest centroids of each query.
    probe = select_topkd(pairwise_sq_dists(x, cents), n_probe)[1].long()

    # Dispatch: each (query, probe-slot) pair's slot in its cluster's
    # block-aligned segment.
    flat_c = probe.reshape(b, n * n_probe)
    q_of = (torch.arange(n * n_probe, device=dev) // n_probe).expand(b, -1)
    rank = _segment_ranks(flat_c)
    counts = torch.zeros(b, n_clusters, dtype=torch.int64, device=dev)
    counts.scatter_add_(1, flat_c, torch.ones_like(flat_c))
    seg_len = (counts + block_t - 1) // block_t * block_t
    ends = seg_len.cumsum(dim=1)
    slot = (ends - seg_len).gather(1, flat_c) + rank  # never dropped
    # Static bound on sum(seg_len), in whole blocks.
    nblocks = -(-(n * n_probe) // block_t) + n_clusters
    total = nblocks * block_t
    qmap = torch.full((b, total), n, dtype=torch.int64, device=dev)
    qmap.scatter_(1, slot, q_of)
    x_pad = torch.cat([x, x.new_zeros(b, 1, d)], dim=1)
    x_disp = _rows(x_pad, qmap).reshape(b, nblocks, block_t, d)
    # Block -> owning cluster; blocks past the used prefix take the BIG
    # pad cluster.
    starts = (torch.arange(nblocks, device=dev) * block_t).expand(b, -1)
    block_c = torch.searchsorted(ends, starts.contiguous(), right=True)
    block_c = block_c.clamp_max(n_clusters)
    feats_pad = torch.cat([cluster_feats, y.new_zeros(b, 1, cap, d)], dim=1)
    sqm_pad = torch.cat([sq_members, torch.full((b, 1, cap), BIG, device=dev)],
                        dim=1)
    feats_blk = _rows(feats_pad, block_c)  # (B, nb, cap, D)
    sqm_blk = _rows(sqm_pad, block_c)  # (B, nb, cap)

    # Per-block dense product: -2 X_blk Y_c^T + ||y||^2.
    xy = torch.matmul(x_disp.float(), feats_blk.float().transpose(-1, -2))
    d_c = sqm_blk[:, :, None, :] - 2.0 * xy  # (B, nb, block_t, cap)

    # Combine: each (query, slot) reads its cap-row back.
    cand_d = _rows(d_c.reshape(b, total, cap), slot).reshape(b, n, n_probe * cap)
    cand_i = _rows(members, probe).reshape(b, n, n_probe * cap)

    kd_eff = min(kd, n_probe * cap)
    vals, cols = select_topkd(cand_d, kd_eff)
    cols = torch.where(vals >= BIG, 0, cols.long())
    idx = cand_i.gather(-1, cols).clamp_max(m - 1)
    dist = vals + x.float().square().sum(-1)[..., None]
    dist = torch.where(vals >= BIG / 2, vals, dist)
    if kd_eff < kd:  # pad to kd for API uniformity
        idx = torch.cat([idx, idx.new_zeros(b, n, kd - kd_eff)], dim=-1)
        dist = torch.cat([dist, dist.new_full((b, n, kd - kd_eff), BIG)], dim=-1)
    return idx, dist


def cluster_digc(
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    *,
    k: int,
    dilation: int = 1,
    n_clusters: Optional[int] = None,
    n_probe: Optional[int] = None,
    capacity_factor: float = 2.0,
    seed: int = 0,
    kmeans_iters: int = 5,
    init_centroids: Optional[torch.Tensor] = None,
    init_valid=None,
    warm_iters: int = 2,
    return_dists: bool = False,
    return_state: bool = False,
):
    """Two-stage approximate graph construction (ClusterViG family).

    1. cluster the co-nodes (k-means, static iterations; cold from a
       seeded permutation, or warm from ``init_centroids``);
    2. bucket members into fixed-capacity cluster lists (overflow drops);
    3. per query, the top ``n_probe`` centroids, then the top k*d over
       the probed clusters' members in dispatch form.

    Accepts (N, D) or (B, N, D). Explicit (M, D) co-nodes beside batched
    (B, N, D) queries are indexed once and shared. ``n_clusters`` and
    ``n_probe`` default to ``default_cluster_params``.

    ``init_valid`` selects the warm start: a () bool tensor picks the warm
    build (``warm_iters`` iterations from ``init_centroids``) or the cold
    one (``kmeans_iters`` from the permutation) for the whole batch; a
    (B,) bool vector picks per row (an all-warm batch pays one build, a
    mixed batch builds both and selects per row). With ``init_valid=None``
    a given ``init_centroids`` means warm at ``kmeans_iters``. The flag
    is read on the host once per call, except while a CUDA graph is
    being captured (see the module docstring).

    ``return_state=True`` also returns {"centroids": (B, C, D)}.
    """
    shared_y = y is not None and y.ndim == 2 and x.ndim == 3
    if shared_y:
        y = y[None].expand((x.shape[0],) + tuple(y.shape))
    x3, y3, _, squeeze = promote_batch(x, y)
    b, m = x3.shape[0], y3.shape[1]
    kd = k * dilation
    n_clusters, n_probe = default_cluster_params(m, n_clusters, n_probe)
    cap = max(int(m / n_clusters * capacity_factor), kd)

    init3 = init_centroids
    if init3 is not None and init3.ndim == 2:
        init3 = init3[None].expand((b,) + tuple(init3.shape))
    if init3 is not None and init3.shape[1] != n_clusters:
        init3 = None  # a stale shape (the workload changed): cold start

    def build_index(iters: int, init_b3, shared: bool = shared_y):
        if shared:
            cents1, members1 = _cluster_index(
                y3[0], n_clusters=n_clusters, cap=cap, seed=seed, iters=iters,
                init_centroids=None if init_b3 is None else init_b3[0])
            return (cents1[None].expand((b,) + tuple(cents1.shape)).contiguous(),
                    members1[None].expand((b,) + tuple(members1.shape)))
        return _cluster_index(y3, n_clusters=n_clusters, cap=cap, seed=seed,
                              iters=iters, init_centroids=init_b3)

    def mixed_index(valid, shared: bool):
        cw, mw = build_index(warm_iters, init3, shared)
        cc, mc = build_index(kmeans_iters, None, shared)
        sel = valid.reshape(valid.shape + (1,) * (3 - valid.ndim))
        return torch.where(sel, cw, cc), torch.where(sel, mw, mc)

    if init3 is None:
        cents, members = build_index(kmeans_iters, None)
    elif init_valid is None:
        cents, members = build_index(kmeans_iters, init3)
    else:
        valid = torch.as_tensor(init_valid, dtype=torch.bool, device=x3.device)
        # A () flag keeps the shared-co-node index; per-row flags index
        # each row on its own (rows carry independent centroids).
        shared = shared_y and valid.ndim == 0
        if capturing(x3):
            cents, members = mixed_index(valid, shared)
        elif _all_rows(valid):
            cents, members = build_index(warm_iters, init3, shared)
        elif valid.ndim == 0:
            cents, members = build_index(kmeans_iters, None, shared)
        else:
            cents, members = mixed_index(valid, shared)

    idx, dist = _cluster_search(x3, y3, cents, members, kd=kd, n_probe=n_probe)
    idx = dilate(idx.to(torch.int32), dilation)
    dist = dilate(dist, dilation)
    if squeeze:
        idx, dist = idx[0], dist[0]
    out = (idx, dist) if return_dists else idx
    if return_state:
        state = {"centroids": cents}
        return (*out, state) if return_dists else (out, state)
    return out


def axial_digc(
    x: torch.Tensor,
    *,
    grid_h: int,
    grid_w: int,
    k: int,
    dilation: int = 1,
    return_dists: bool = False,
):
    """Axial construction (GreedyViG family): each patch considers only its
    grid row and column, O(N (H + W) D) with no full distance matrix.

    x (N, D) or (B, N, D) with N == grid_h * grid_w in row-major patch
    order. The candidates are shared across the batch: one gather and one
    selection. When k*d exceeds the H + W candidates the lists are padded
    with index 0 at distance BIG before the dilation, as in JAX."""
    x3, _, _, squeeze = promote_batch(x)
    b, n, _ = x3.shape
    if n != grid_h * grid_w:
        raise ValueError(f"axial grid {grid_h}x{grid_w} does not match N={n} nodes")
    kd = k * dilation
    dev = x3.device
    rows = torch.arange(grid_h, device=dev)
    cols = torch.arange(grid_w, device=dev)
    # Row candidates of patch (r, c): r*W + c' for every c'; column
    # candidates: r'*W + c for every r'.
    row_ids = (rows[:, None, None] * grid_w + cols[None, None, :]).expand(
        grid_h, grid_w, grid_w)
    col_ids = (rows[None, None, :] * grid_w + cols[None, :, None]).expand(
        grid_h, grid_w, grid_h)
    cand = torch.cat([row_ids, col_ids], dim=-1).reshape(n, grid_w + grid_h)

    feats = x3[:, cand]  # (B, N, H+W, D)
    dists = (feats - x3[:, :, None, :]).square().sum(-1)  # (B, N, H+W)
    # The row and column lists meet exactly at the query itself: mask the
    # column-side duplicate so it cannot displace a neighbour.
    dup = cand[:, grid_w:] == torch.arange(n, device=dev)[:, None]  # (N, H)
    dists = torch.cat([dists[..., :grid_w],
                       torch.where(dup, BIG, dists[..., grid_w:])], dim=-1)
    kd_eff = min(kd, grid_w + grid_h)
    dist, sel = select_topkd(dists, kd_eff)
    idx = cand.expand((b,) + tuple(cand.shape)).gather(-1, sel.long())
    idx = idx.to(torch.int32)
    if kd_eff < kd:
        idx = torch.cat([idx, idx.new_zeros(b, n, kd - kd_eff)], dim=-1)
        dist = torch.cat([dist, dist.new_full((b, n, kd - kd_eff), BIG)], dim=-1)
    idx = dilate(idx, dilation)
    dist = dilate(dist, dilation)
    if squeeze:
        idx, dist = idx[0], dist[0]
    if return_dists:
        return idx, dist
    return idx


def recall_vs_exact(x, y, idx_approx, k: int) -> float:
    """Neighbour-set recall of an approximate construction against
    Algorithm 1 (``digc_reference``)."""
    exact = digc_reference(x, y, k=k).cpu().numpy().reshape(-1, k)
    approx = np.asarray(torch.as_tensor(idx_approx).cpu())[..., :k]
    approx = approx.reshape(-1, k)
    hits = sum(len(set(e.tolist()) & set(a.tolist()))
               for e, a in zip(exact, approx))
    return hits / exact.size


# --------------------------------------------------------------------------
# Registry entries (DESIGN.md §4).


def _cluster_kw(spec: DigcSpec) -> dict:
    return dict(
        k=spec.k, dilation=spec.dilation,
        n_clusters=spec.n_clusters, n_probe=spec.n_probe,
        capacity_factor=(spec.capacity_factor
                         if spec.capacity_factor is not None else 2.0),
        seed=spec.seed if spec.seed is not None else 0,
        return_dists=True,
    )


def _build_cluster(x, y, pos_bias, spec: DigcSpec, state_entry=None):
    # No eager ``cache=`` here: the JAX package's DigcCache warm start is
    # not ported (the functional state carries the centroids).
    del pos_bias  # validated unsupported upstream
    if state_entry is not None:
        return _build_cluster_stateful(x, y, spec, state_entry)
    return cluster_digc(x, y, **_cluster_kw(spec))


def _build_cluster_stateful(x, y, spec: DigcSpec, entry):
    """(x, y, spec, DigcStateEntry) -> (idx, dist, new entry): warm/cold
    per the entry's counter (per batch row when it carries ``row_step``),
    and the new centroids written into the entry."""
    m = y.shape[1] if y is not None else x.shape[1]
    n_clusters, _ = default_cluster_params(m, spec.n_clusters, spec.n_probe)
    expected = (x.shape[0], n_clusters, x.shape[-1])
    init = entry.centroids
    if init is None or tuple(init.shape) != expected:
        # No centroid buffer for this workload: cold build, and only the
        # counter advances (never a mismatched shape into the state).
        idx, dist = cluster_digc(x, y, **_cluster_kw(spec))
        return idx, dist, entry.bump()
    valid = entry.row_warm if entry.row_step is not None else entry.warm
    idx, dist, st = cluster_digc(x, y, init_centroids=init, init_valid=valid,
                                 return_state=True, **_cluster_kw(spec))
    return idx, dist, entry.bump(centroids=st["centroids"].to(init.dtype))


def _build_axial(x, y, pos_bias, spec: DigcSpec):
    del pos_bias
    n = x.shape[1]
    if y is not None:
        # Axial candidates are x's own grid row and column: a self-graph
        # construction. Pooled co-nodes and any explicit y take the exact
        # streaming tier.
        return digc_blocked(x, y, k=spec.k, dilation=spec.dilation,
                            return_dists=True)
    gh, gw = spec.grid_h, spec.grid_w
    if gh is None and gw is None:
        side = int(round(n ** 0.5))
        if side * side != n:
            raise ValueError(f"axial DIGC needs grid_h/grid_w for non-square N={n}")
        gh = gw = side
    elif gh is None:
        gh = n // gw
    elif gw is None:
        gw = n // gh
    if gh * gw != n:
        raise ValueError(f"axial grid {gh}x{gw} does not match N={n} nodes")
    return axial_digc(x, grid_h=gh, grid_w=gw, k=spec.k, dilation=spec.dilation,
                      return_dists=True)


register(GraphBuilder(
    name="cluster",
    build=_build_cluster,
    knobs=frozenset({"n_clusters", "n_probe", "capacity_factor", "seed"})
    | REUSE_KNOBS,
    exact=False,
    supports_state=True,  # centroid warm starts through DigcState
    doc="ClusterViG-family IVF search: k-means index (shared co-nodes "
        "indexed once, DigcState warm starts) + dispatch-form probe",
))

register(GraphBuilder(
    name="axial",
    build=_build_axial,
    knobs=frozenset({"grid_h", "grid_w"}),
    exact=False,
    doc="GreedyViG-family axial (row+column) construction; falls back "
        "to blocked when co-nodes are pooled (M != N)",
))
