"""KNN-sparse attention built on DIGC (port of ``repro/core/knn_attention.py``).

Each query attends only to its k nearest keys under squared euclidean
distance; the neighbour lists are a causal DIGC over the sequence. For
unit-norm keys the distance ranking equals the dot-product ranking, so
this is a sparse approximation of softmax attention. Softmax runs over
the gathered keys' true dot-product logits; lanes whose DIGC distance is
BIG (causally excluded) are masked out of it.

``knn_attention_mha`` puts the heads in the batch dimension of one DIGC
call. The LM layers that call these functions are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.digc import BIG, digc


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            idx: torch.Tensor, dist: torch.Tensor, scale: float) -> torch.Tensor:
    """q (B, S, Dh), k/v (B, T, Dh), idx/dist (B, S, n) -> (B, S, Dh):
    softmax over the gathered neighbours' logits, BIG lanes masked; a row
    with no valid lane gives zeros."""
    batch = torch.arange(k.shape[0], device=k.device)[:, None, None]
    ids = idx.long()
    kg, vg = k[batch, ids], v[batch, ids]  # (B, S, n, Dh)
    logits = torch.einsum("bsd,bsnd->bsn", q, kg) * scale
    invalid = dist >= BIG / 2
    logits = logits.masked_fill(invalid, float("-inf"))
    w = torch.softmax(logits, dim=-1).masked_fill(invalid, 0.0)
    return torch.einsum("bsn,bsnd->bsd", w, vg)


def knn_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    num_neighbors: int,
    causal: bool = True,
    impl: str = "blocked",
    scale: Optional[float] = None,
    **digc_kwargs,
) -> torch.Tensor:
    """Single-head KNN attention. q: (S, Dh), k/v: (T, Dh) -> (S, Dh)."""
    return knn_attention_mha(q[:, None], k[:, None], v[:, None],
                             num_neighbors=num_neighbors, causal=causal,
                             impl=impl, scale=scale, **digc_kwargs)[:, 0]


def knn_attention_mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    num_neighbors: int,
    causal: bool = True,
    impl: str = "blocked",
    scale: Optional[float] = None,
    **digc_kwargs,
) -> torch.Tensor:
    """Multi-head KNN attention. q: (S, H, Dh), k/v: (T, H, Dh) ->
    (S, H, Dh); one DIGC call with the heads as its batch."""
    dh = q.shape[-1]
    nn = min(num_neighbors, k.shape[0])
    scale = scale if scale is not None else dh**-0.5
    qh, kh, vh = (t.transpose(0, 1).contiguous() for t in (q, k, v))
    idx, dist = digc(qh, kh, k=nn, causal=causal, impl=impl,
                     return_dists=True, **digc_kwargs)
    return _attend(qh, kh, vh, idx, dist, scale).transpose(0, 1)


def knn_attention_decode(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len,
    *,
    num_neighbors: int,
) -> torch.Tensor:
    """Single-token decode: the nearest keys of one distance row per head
    (a stable sort: the lowest index wins a tie, as ``lax.top_k``), then
    softmax over them. q: (H, Dh); caches: (T, H, Dh); ``cache_len``: the
    valid prefix length."""
    t, _, dh = k_cache.shape
    nn = min(num_neighbors, t)
    kh = k_cache.transpose(0, 1)  # (H, T, Dh)
    vh = v_cache.transpose(0, 1)
    d = ((kh - q[:, None, :]) ** 2).sum(-1)  # (H, T)
    valid = torch.arange(t, device=q.device) < torch.as_tensor(cache_len,
                                                               device=q.device)
    d = torch.where(valid, d, BIG)
    dist, idx = torch.sort(d, dim=-1, stable=True)
    out = _attend(q[:, None], kh, vh, idx[:, None, :nn], dist[:, None, :nn],
                  dh**-0.5)
    return out[:, 0]
