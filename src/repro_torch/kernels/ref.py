"""Full-matrix oracle for the DIGC kernel (Algorithm 1, no blocking)."""

from __future__ import annotations

from typing import Optional

import torch


def pairwise_sq_dists(x: torch.Tensor, y: torch.Tensor,
                      pos_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., N, D) x (..., M, D) -> (..., N, M) squared distances in fp32,
    in the kernel's order: (||x||^2 - 2 x.y) + ||y||^2."""
    x = x.float()
    y = y.float()
    d = (
        (x * x).sum(-1, keepdim=True)
        - 2.0 * (x @ y.transpose(-1, -2))
        + (y * y).sum(-1).unsqueeze(-2)
    )
    if pos_bias is not None:
        d = d + pos_bias
    return d


def digc_reference(x: torch.Tensor, y: torch.Tensor,
                   pos_bias: Optional[torch.Tensor] = None, *, kd: int):
    """Full-matrix top-kd: (dist, idx), each (..., N, kd), ascending.

    A stable sort keeps the lowest index first among equal distances,
    the tie rule of ``lax.top_k``; ``torch.topk`` does not promise it.
    """
    dist, idx = torch.sort(pairwise_sq_dists(x, y, pos_bias), dim=-1,
                           stable=True)
    return dist[..., :kd], idx[..., :kd].to(torch.int32)
