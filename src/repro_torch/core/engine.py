"""The streaming DIGC engine (port of ``repro/core/engine.py::stream_topk``).

The blocked tier runs through ``stream_topk``: the distance matrix is
formed one (block_n x block_m) tile at a time and folded into a running
top-kd list, so live memory is O(B * block_n * block_m), never
O(B * N * M). The merge is a knob (``DigcSpec.merge``):

  * ``"select"`` (default): each tile reduced to its own top-kd
    (``select_topkd``), the tiles' survivors merged;
  * ``"topk"``: every tile merged straight into the running list
    (``merge_topk_xla``);
  * ``"packed"``: int32 (dist|idx) keys (``core/packedkey.py``), the
    tile's sorted top-kd_pad merged into a sorted running buffer
    (``merge_packed_xla``). Tie-tolerant: distances are truncated.

``select`` and ``topk`` are exact and share one lexicographic selection:
a stable sort of the candidates by distance, which keeps the lowest index
first among equal distances because candidates arrive in ascending index
order. The JAX package's grouped extraction and ``lax.top_k`` are two
realizations of that same result.

Norms: ``||y||^2`` is computed once per call (shared with ``||x||^2``
for a self-graph) or passed in as ``sq_y``; ``fuse_norms`` folds them
into the product as [-2x, 1, ||x||^2] . [y, ||y||^2, 1] (another fp32
summation order, so tie-tolerant); ``mxu_bf16`` rounds the product's
operands to bf16 and multiplies the rounded values in fp32, keeping the
norms from the fp32 inputs. ``m_valid`` and the padding of the last
co-node tile are masked through the norm term (BIG).

``DigcCache`` is the legacy eager cache: host-side construction state
(co-node norms, cluster centroids) keyed by (kind, caller key), read and
written only outside CUDA-graph capture. The functional
``core.state.DigcState`` supersedes it; ``VigServeEngine(mode="eager")``
engages it for a tier with ``supports_cache``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.packedkey import (
    INT_BIG,
    idx_bits_for,
    merge_sorted,
    next_pow2,
    pack_keys,
    topk_keys,
    unpack_keys,
)

BIG = float(1e30)

MERGE_STRATEGIES = ("select", "topk", "packed")

# Group width of the JAX package's grouped selection; the knob is
# validated as there, though the sort here does not use groups.
_SELECT_GROUP_W = 32
_SELECT_GROUP_W_MAX = 64


def live_mask(m_valid, device: torch.device) -> torch.Tensor:
    """A pad-node mask ((M,) or (B, M)) as a bool tensor on ``device``.
    A bool tensor already there is returned as it is: nothing is copied,
    so a captured CUDA graph reads the caller's buffer, a static input
    refilled before each replay. Anything else (numpy, a CPU tensor) is
    copied, which a capture cannot record: that raises."""
    if (isinstance(m_valid, torch.Tensor) and m_valid.dtype == torch.bool
            and m_valid.device == device):
        return m_valid
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise ValueError(
            "m_valid must be a bool tensor on the capturing device: a host "
            "mask would be copied once, into the captured graph")
    if isinstance(m_valid, torch.Tensor):
        return m_valid.to(device=device, dtype=torch.bool)
    return torch.as_tensor(m_valid, dtype=torch.bool, device=device)


def _ceil_to(v: int, mult: int) -> int:
    return ((v + mult - 1) // mult) * mult


def select_topkd(d_blk: torch.Tensor, kd: int,
                 group_w: int = _SELECT_GROUP_W):
    """Top-kd of each row of ``d_blk`` (..., N, W), ascending by
    (distance, column): (dist, col), each (..., N, min(kd, W)).

    ``group_w`` is accepted for the JAX signature; a stable sort gives
    the grouped extraction's result. Unlike the JAX version, a tile
    narrower than kd yields W entries, not BIG-padded lanes."""
    del group_w
    dist, col = torch.sort(d_blk, dim=-1, stable=True)
    return dist[..., :kd], col[..., :kd].to(torch.int32)


def merge_topk_xla(run_d, run_i, blk_d, blk_i, kd: int):
    """Lowest kd of a running list and a block of candidates, ascending by
    distance; among equal distances the earlier position in
    ``[run, blk]`` wins (a stable sort, as ``lax.top_k`` of the negated
    concatenation). The streaming engine feeds tiles in column order, so
    there every block index exceeds every running index and the order is
    (distance, index); the ring feeds shards in hop order, so a tie goes
    to the shard met first."""
    cand_d = torch.cat([run_d, blk_d], dim=-1)
    cand_i = torch.cat([run_i, blk_i], dim=-1)
    dist, sel = torch.sort(cand_d, dim=-1, stable=True)
    return dist[..., :kd], torch.gather(cand_i, -1, sel[..., :kd])


def merge_packed_xla(run_k: torch.Tensor, blk_k: torch.Tensor, kd: int):
    """The tile's sorted top-kd_pad keys merged into the sorted running
    buffer ``run_k``; returns its lowest kd keys, sorted."""
    kd_pad = next_pow2(kd)
    if run_k.shape[-1] < kd_pad:
        fill = run_k.new_full(run_k.shape[:-1] + (kd_pad - run_k.shape[-1],),
                              INT_BIG)
        run_k = torch.cat([run_k, fill], dim=-1)
    merged = merge_sorted(run_k[..., :kd_pad], topk_keys(blk_k, kd_pad))
    return merged[..., :kd]


def stream_topk(
    x3: torch.Tensor,
    y3: Optional[torch.Tensor] = None,
    pos_bias: Optional[torch.Tensor] = None,
    *,
    kd: int,
    block_m: Optional[int] = None,
    block_n: Optional[int] = None,
    merge: Optional[str] = None,
    fuse_norms: bool = False,
    mxu_bf16: bool = False,
    causal: bool = False,
    sq_y: Optional[torch.Tensor] = None,
    group_w: Optional[int] = None,
    m_valid: Optional[torch.Tensor] = None,
):
    """Streaming top-kd over a (block_n x block_m) tile grid.

    x3 (B, N, D); y3 (B, M, D) or None for a self-graph; pos_bias
    (B, N, M) or None. Returns (dist fp32, idx int32), each (B, N, kd),
    ascending; masked lanes carry BIG. ``block_m=None`` takes the whole
    co-node set in one tile, ``block_n=None`` disables query tiling.
    ``sq_y`` takes precomputed co-node squared norms (B, M); ``m_valid``
    ((M,) or (B, M) bool) marks live co-nodes.
    """
    if merge is None:
        merge = "select"
    if merge not in MERGE_STRATEGIES:
        raise ValueError(
            f"unknown merge strategy {merge!r}; one of {MERGE_STRATEGIES}"
        )
    if group_w is None:
        group_w = _SELECT_GROUP_W
    if not 1 <= group_w <= _SELECT_GROUP_W_MAX:
        raise ValueError(
            f"group_w={group_w} out of range [1, {_SELECT_GROUP_W_MAX}]"
        )
    self_graph = y3 is None
    b, n, _ = x3.shape
    m = n if self_graph else y3.shape[1]
    if kd > m:
        raise ValueError(f"k*dilation={kd} exceeds number of co-nodes M={m}")

    x3 = x3.float()
    y3 = x3 if self_graph else y3.float()
    sq_x = (x3 * x3).sum(-1)  # (B, N)
    if sq_y is None:
        sq_y = sq_x if self_graph else (y3 * y3).sum(-1)
    else:
        sq_y = sq_y.float()
    if m_valid is not None:
        # Pad co-nodes are masked through their norm: one site covers
        # every merge and the fused operands.
        mask = live_mask(m_valid, x3.device)
        mask = mask[None, :] if mask.ndim == 1 else mask
        if mask.shape[-1] != m:
            raise ValueError(
                f"m_valid has {mask.shape[-1]} co-node lanes, expected M={m}"
            )
        sq_y = torch.where(mask, sq_y, BIG)

    block_m = m if block_m is None else max(1, min(block_m, m))
    m_pad = _ceil_to(m, block_m)
    y_p = F.pad(y3, (0, 0, 0, m_pad - m))
    sq_y_p = F.pad(sq_y, (0, m_pad - m)).expand(b, m_pad)
    live = torch.arange(m_pad, device=x3.device)[None, :] < m
    sq_y_p = torch.where(live, sq_y_p, BIG)

    if mxu_bf16:
        fuse_norms = False  # the norm terms stay fp32
    if fuse_norms:
        x_op = torch.cat([-2.0 * x3, x3.new_ones(b, n, 1), sq_x[..., None]], -1)
        y_op = torch.cat([y_p, sq_y_p[..., None], y_p.new_ones(b, m_pad, 1)], -1)
    elif mxu_bf16:
        # bf16 x bf16 products are exact in fp32: round the operands and
        # multiply the rounded values in fp32, as JAX's
        # preferred_element_type=f32 does (torch's bf16 matmul would
        # round the result to bf16).
        x_op = x3.to(torch.bfloat16).float()
        y_op = y_p.to(torch.bfloat16).float()
    else:
        x_op, y_op = x3, y_p
    if pos_bias is not None:
        pos_bias = F.pad(pos_bias.float(), (0, m_pad - m))
    idx_bits = idx_bits_for(m_pad) if merge == "packed" else 0

    def tile(r0: int, r1: int, c0: int):
        d_blk = x_op[:, r0:r1] @ y_op[:, c0:c0 + block_m].transpose(1, 2)
        if not fuse_norms:
            d_blk = (sq_x[:, r0:r1, None] - 2.0 * d_blk
                     + sq_y_p[:, None, c0:c0 + block_m])
        if pos_bias is not None:
            d_blk = d_blk + pos_bias[:, r0:r1, c0:c0 + block_m]
        cols = torch.arange(c0, c0 + block_m, device=x3.device,
                            dtype=torch.int32)
        if causal:
            rows = torch.arange(r0, r1, device=x3.device)[:, None]
            d_blk = torch.where(cols[None, :] <= rows, d_blk, BIG)
        return d_blk, cols.expand_as(d_blk)

    def run_queries(r0: int, r1: int):
        if merge == "packed":
            run_k = torch.full((b, r1 - r0, kd), INT_BIG, dtype=torch.int32,
                               device=x3.device)
            for c0 in range(0, m_pad, block_m):
                d_blk, cols = tile(r0, r1, c0)
                run_k = merge_packed_xla(run_k, pack_keys(d_blk, cols, idx_bits),
                                         kd)
            return unpack_keys(run_k, idx_bits)
        run_d = x3.new_empty(b, r1 - r0, 0)
        run_i = torch.empty((b, r1 - r0, 0), dtype=torch.int32, device=x3.device)
        for c0 in range(0, m_pad, block_m):
            d_blk, cols = tile(r0, r1, c0)
            if merge == "select":
                d_blk, col = select_topkd(d_blk, kd, group_w)
                cols = col + c0
            run_d, run_i = merge_topk_xla(run_d, run_i, d_blk, cols, kd)
        return run_d, run_i

    step = n if block_n is None else max(1, block_n)
    parts = [run_queries(r0, min(r0 + step, n)) for r0 in range(0, n, step)]
    if len(parts) == 1:
        return parts[0]
    return (torch.cat([p[0] for p in parts], 1),
            torch.cat([p[1] for p in parts], 1))


# ---------------------------------------------------------------------------
# Cross-layer / cross-request cache


@dataclasses.dataclass
class DigcCache:
    """Host-side cache of reusable graph-construction state: the legacy
    eager shim (new code threads the functional ``DigcState``).

    Holds co-node squared norms (serving a fixed gallery), cluster
    centroids (layer-to-layer and request-to-request k-means warm starts)
    and other builder state, keyed by (kind, caller key). Entries are read
    and written only for tensors with values: while a CUDA graph is being
    captured (and for ``meta`` tensors) the cache is bypassed, since a
    value read then would be baked into the graph as a stale constant.
    """

    max_entries: int = 256
    _store: dict = dataclasses.field(default_factory=dict)
    hits: int = 0
    misses: int = 0

    @staticmethod
    def usable(*tensors: torch.Tensor) -> bool:
        """False while any tensor's stream captures a CUDA graph, or for
        a tensor without values (``meta``)."""
        return not any(
            t.device.type == "meta"
            or (t.is_cuda and torch.cuda.is_current_stream_capturing())
            for t in tensors)

    def get(self, kind: str, key: Any):
        entry = self._store.get((kind, key))
        if entry is None:
            self.misses += 1
        else:
            self.hits += 1
        return entry

    def put(self, kind: str, key: Any, value: torch.Tensor) -> None:
        if not self.usable(value):
            return
        if len(self._store) >= self.max_entries:
            self._store.pop(next(iter(self._store)))
        self._store[(kind, key)] = value

    def norms(self, key: Any, y: torch.Tensor) -> torch.Tensor:
        """||y||^2 of a co-node set identified by ``key``, which must name
        its contents (e.g. a gallery version tag): shapes alone are not
        enough."""
        if not self.usable(y):
            return y.float().square().sum(-1)
        cached = self.get("sq_y", key)
        if cached is not None and tuple(cached.shape) == tuple(y.shape[:-1]):
            return cached
        sq = y.float().square().sum(-1)
        self.put("sq_y", key, sq)
        return sq

    def stats(self) -> dict:
        return {"entries": len(self._store), "hits": self.hits,
                "misses": self.misses}

    def clear(self) -> None:
        self._store.clear()
