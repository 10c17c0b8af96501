"""KNN-sparse attention built on DIGC (port of ``repro/core/knn_attention.py``).

Each query attends only to its k nearest keys under squared euclidean
distance; the neighbour lists are a causal DIGC over the sequence. For
unit-norm keys the distance ranking equals the dot-product ranking, so
this is a sparse approximation of softmax attention. Softmax runs over
the gathered keys' true dot-product logits; lanes whose DIGC distance is
BIG (causally excluded) are masked out of it.

``knn_attention_mha`` puts the heads (and any leading batch dimensions)
in the batch dimension of one DIGC call: the LM's prefill
(``models/layers.py::knn_attention_apply``) runs it on the ``blocked``
tier, as JAX does. ``knn_attention_decode_rows`` is the LM's decode, one
stable sort over the (B, H, T) distance rows, each row at its own cache
length; ``knn_attention_decode`` is its single-row form.
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
    """Multi-head KNN attention. q: (..., S, H, Dh), k/v: (..., T, H, Dh)
    -> (..., S, H, Dh); one DIGC call with the leading dimensions and the
    heads as its batch."""
    *lead, s, h, dh = q.shape
    t = k.shape[-3]
    nn = min(num_neighbors, t)
    scale = scale if scale is not None else dh**-0.5

    def rows(a, n):  # (..., n, H, Dh) -> (prod(...) * H, n, Dh), contiguous
        return a.reshape(-1, n, h, dh).transpose(1, 2).contiguous().reshape(-1, n, dh)

    qh, kh, vh = rows(q, s), rows(k, t), rows(v, t)
    idx, dist = digc(qh, kh, k=nn, causal=causal, impl=impl,
                     return_dists=True, **digc_kwargs)
    out = _attend(qh, kh, vh, idx, dist, scale)  # (G * H, S, Dh)
    return out.reshape(-1, h, s, dh).transpose(1, 2).reshape(*lead, s, h, dh)


def knn_attention_decode_rows(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len,
    *,
    num_neighbors: int,
) -> torch.Tensor:
    """Batched single-token decode: the nearest keys of each (row, head)
    distance row, one stable sort over (B, H, T) (the lowest index wins a
    tie, as ``lax.top_k``), then softmax over them. q: (B, H, Dh);
    caches: (B, T, H, Dh); ``cache_len``: each row's valid prefix length,
    (B,) or a scalar -> (B, H, Dh)."""
    b, t, h, dh = k_cache.shape
    nn = min(num_neighbors, t)
    kh = k_cache.transpose(1, 2)  # (B, H, T, Dh)
    vh = v_cache.transpose(1, 2)
    d = ((kh - q[:, :, None, :]) ** 2).sum(-1)  # (B, H, T)
    lens = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    valid = torch.arange(t, device=q.device)[None, :] < lens  # (B, T)
    d = torch.where(valid[:, None, :], d, BIG)
    dist, idx = torch.sort(d, dim=-1, stable=True)
    g = b * h
    out = _attend(q.reshape(g, 1, dh), kh.reshape(g, t, dh), vh.reshape(g, t, dh),
                  idx.reshape(g, 1, t)[..., :nn], dist.reshape(g, 1, t)[..., :nn],
                  dh**-0.5)
    return out.reshape(b, h, dh)


def knn_attention_decode(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len,
    *,
    num_neighbors: int,
) -> torch.Tensor:
    """Single-token decode of one row (``knn_attention_decode_rows`` at
    B = 1). q: (H, Dh); caches: (T, H, Dh); ``cache_len``: the valid
    prefix length."""
    return knn_attention_decode_rows(q[None], k_cache[None], v_cache[None],
                                     cache_len, num_neighbors=num_neighbors)[0]
