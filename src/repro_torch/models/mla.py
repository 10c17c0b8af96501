"""Multi-head Latent Attention, DeepSeek-V2 (port of ``repro/models/mla.py``).
Keys and values are compressed to a latent ``c_kv`` (kv_lora wide, RMS
normed) plus one RoPE key ``k_pe`` shared by the heads; the decode cache
holds only those, (B, T, kv_lora) and (B, T, rope).

Prefill expands per-head keys and values from the latent and runs causal
``mha_chunked``. The softmax scale is q's width to the -1/2, nope + rope,
as JAX's, times YaRN's ``mscale`` squared under a config's ``yarn``
(``softmax_scale``), which also sets the rotary frequencies. Decode
uses the absorbed form: the query is taken into the latent space
(``q_nope @ W_uk^T``), scored against the cached latents and RoPE keys,
and the context is mapped out through ``W_uv``. Each row writes its new
``c_kv`` and ``k_pe`` at its own slot in place, for the rows ``rows``
names (all when None), as ``layers.attention_apply`` does.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    NEG_INF,
    _is_vector,
    _out_proj,
    _pos_vector,
    _proj_heads,
    _rms_head,
    _write_rows,
    apply_rope,
    mha_chunked,
    rope_angles,
    yarn_mscale,
)
from repro_torch.models.module import spec


def mla_spec(cfg: ModelConfig):
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    return {
        "wq": spec((d, h, qk), ("embed", "heads", "head_dim")),
        "w_dkv": spec((d, m.kv_lora), ("embed", "kv_lora")),
        "w_kpe": spec((d, m.qk_rope_dim), ("embed", "head_dim")),
        "kv_norm": spec((m.kv_lora,), ("kv_lora",), init="ones"),
        "w_uk": spec((m.kv_lora, h, m.qk_nope_dim),
                     ("kv_lora", "heads", "head_dim")),
        "w_uv": spec((m.kv_lora, h, m.v_dim), ("kv_lora", "heads", "head_dim")),
        "wo": spec((h, m.v_dim, d), ("heads", "head_dim", "embed")),
    }


def softmax_scale(cfg: ModelConfig) -> float:
    """(nope + rope)^-1/2, times ``yarn_mscale(factor, mscale_all_dim)``
    squared under YaRN (DeepSeek's ``softmax_scale``)."""
    m = cfg.mla
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    yarn = getattr(cfg, "yarn", None)
    if yarn is not None and yarn.mscale_all_dim:
        scale *= yarn_mscale(yarn.factor, yarn.mscale_all_dim) ** 2
    return scale


def _rope(x: torch.Tensor, cfg: ModelConfig, positions) -> torch.Tensor:
    """RoPE over the rotary dims (B, S, H, rope); under YaRN with its
    frequencies, cos and sin scaled by ``mscale / mscale_all_dim``'s
    ratio of corrections (1 when they are equal)."""
    m = cfg.mla
    yarn = getattr(cfg, "yarn", None)
    out = apply_rope(x, rope_angles(positions, m.qk_rope_dim, cfg.rope_theta,
                                    yarn=yarn))
    if yarn is not None:
        ratio = (yarn_mscale(yarn.factor, yarn.mscale)
                 / yarn_mscale(yarn.factor, yarn.mscale_all_dim))
        if ratio != 1.0:
            out = out * ratio
    return out


def _compress(params, x: torch.Tensor, cfg: ModelConfig, positions):
    """x -> (c_kv (B,S,lora), k_pe (B,S,rope)) cache entries."""
    dt = cfg.compute_dtype
    c_kv = _rms_head(x @ params["w_dkv"].to(dt), params["kv_norm"])
    k_pe = _rope((x @ params["w_kpe"].to(dt))[:, :, None, :], cfg, positions)
    return c_kv, k_pe[:, :, 0, :]


def _queries(params, x: torch.Tensor, cfg: ModelConfig, positions):
    m = cfg.mla
    q = _proj_heads(x, params["wq"], cfg.compute_dtype)
    q_pe = _rope(q[..., m.qk_nope_dim:], cfg, positions)
    return q[..., :m.qk_nope_dim], q_pe


def mla_apply(params, x: torch.Tensor, cfg: ModelConfig, *, positions,
              cache: Optional[dict] = None, pos=None, rows=None):
    """prefill: cache=None -> (out, (c_kv, k_pe)).
    decode: cache={"c_kv", "k_pe"} and ``pos``, a scalar or a (B,)
    per-slot vector -> (out, cache), written in place."""
    m = cfg.mla
    dt = cfg.compute_dtype
    h = cfg.num_heads
    c_kv, k_pe = _compress(params, x, cfg, positions)
    q_nope, q_pe = _queries(params, x, cfg, positions)

    if cache is None:
        k_nope = _proj_heads(c_kv, params["w_uk"], dt)
        v = _proj_heads(c_kv, params["w_uv"], dt)
        q_cat = torch.cat([q_nope, q_pe], -1)
        k_cat = torch.cat([k_nope, k_pe[:, :, None, :].expand(
            *k_pe.shape[:2], h, m.qk_rope_dim)], -1)
        out = mha_chunked(q_cat, k_cat, v, causal=True, q_chunk=cfg.q_chunk,
                          scale=softmax_scale(cfg))
        return _out_proj(out, params["wo"], dt), (c_kv, k_pe)

    b = x.shape[0]
    t = cache["c_kv"].shape[1]
    pv = _pos_vector(pos, b, x.device)
    _write_rows(cache, {"c_kv": c_kv, "k_pe": k_pe}, pv, rows,
                _is_vector(pos))
    scale = softmax_scale(cfg)
    c_cache = cache["c_kv"].to(dt)
    # absorb W_uk into the query: q_lat = q_nope @ W_uk^T per head
    q_lat = torch.einsum("bshk,lhk->bshl", q_nope, params["w_uk"].to(dt))
    logits = (torch.einsum("bshl,btl->bhst", q_lat, c_cache)
              + torch.einsum("bshr,btr->bhst", q_pe, cache["k_pe"].to(dt))
              ).float() * scale
    mask = torch.arange(t, device=x.device)[None, :] <= pv[:, None]  # (B, T)
    logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(dt)
    ctx = torch.einsum("bhst,btl->bshl", w, c_cache)
    out = torch.einsum("bshl,lhk->bshk", ctx, params["w_uv"].to(dt))
    return _out_proj(out, params["wo"], dt), cache
