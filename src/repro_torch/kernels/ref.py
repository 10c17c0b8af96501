"""The distance matrix of the DIGC kernel's plain version (Algorithm 1,
no blocking)."""

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
