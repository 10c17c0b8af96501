"""Graph operations consuming DIGC output (port of ``repro/core/graph.py``).

ViG's Grapher block uses max-relative graph convolution (MRConv):
    agg_i = max_{j in N(i)} (x_j - x_i)
    out_i = W [x_i ; agg_i]
Indices arrive as int32 (the public layout) and are widened to int64
here, where torch's indexing needs them. Unlike ``jnp.take``, an index
outside [0, M) raises instead of being filled.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import resolve_device


def knn_gather(y: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather neighbour features. y: (M, D), idx: (N, k) -> (N, k, D);
    batched (B, M, D) + (B, N, k) -> (B, N, k, D)."""
    ids = idx.long()
    if y.ndim == 2:
        return y[ids]
    batch = torch.arange(y.shape[0], device=y.device)[:, None, None]
    return y[batch, ids]


def mr_aggregate(x: torch.Tensor, y: torch.Tensor,
                 idx: torch.Tensor) -> torch.Tensor:
    """Max-relative aggregation: max_j (y_j - x_i). Output matches x's
    rank: (N, D) or (B, N, D)."""
    neigh = knn_gather(y, idx)
    return (neigh - x[..., :, None, :]).amax(dim=-2)


def sum_aggregate(x: torch.Tensor, y: torch.Tensor,
                  idx: torch.Tensor) -> torch.Tensor:
    neigh = knn_gather(y, idx)
    return (neigh - x[..., :, None, :]).sum(dim=-2)


def mean_aggregate(x: torch.Tensor, y: torch.Tensor,
                   idx: torch.Tensor) -> torch.Tensor:
    neigh = knn_gather(y, idx)
    return (neigh - x[..., :, None, :]).mean(dim=-2)


AGGREGATORS = {
    "max": mr_aggregate,
    "sum": sum_aggregate,
    "mean": mean_aggregate,
}


def edge_list(idx: torch.Tensor) -> torch.Tensor:
    """(N, k) neighbour indices -> COO edge list (2, N*k) of (src=j, dst=i)."""
    n, k = idx.shape
    dst = torch.arange(n, dtype=idx.dtype, device=idx.device).repeat_interleave(k)
    return torch.stack([idx.reshape(-1), dst])


def degree_histogram(idx: torch.Tensor, m: int) -> torch.Tensor:
    """In-degree of each co-node given neighbour lists (diagnostics)."""
    counts = torch.bincount(idx.reshape(-1).long(), minlength=m)
    return counts[:m].to(torch.int32)


def grid_pos_bias(h: int, w: int, hc: Optional[int] = None,
                  wc: Optional[int] = None, scale: float = 0.0,
                  device="cuda") -> torch.Tensor:
    """Relative positional bias P (N, M) between an h*w node grid and an
    hc*wc co-node grid (co-grid defaults to node grid); ``scale`` 0
    returns zeros. Made on the card unless ``device="cpu"``."""
    device = resolve_device(device)
    hc = hc or h
    wc = wc or w

    def coords(gh, gw):
        ys, xs = torch.meshgrid(torch.arange(gh, device=device),
                                torch.arange(gw, device=device), indexing="ij")
        return torch.stack([ys.reshape(-1) / max(gh - 1, 1),
                            xs.reshape(-1) / max(gw - 1, 1)], -1)

    pn, pc = coords(h, w), coords(hc, wc)
    d2 = ((pn[:, None, :] - pc[None, :, :]) ** 2).sum(-1)
    return (scale * d2).to(torch.float32)
