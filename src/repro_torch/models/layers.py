"""Layer library of the decoder LM (port of ``repro/models/layers.py``):
norms, rotary embeddings (standard and M-RoPE), sinusoidal positions,
embedding, MLPs, and grouped-query attention (full, local, KNN, and the
encoder-decoder's cross attention). Pure functions over param dicts from
``module.ParamSpec``; the MLA layer is ``models/mla.py``.

Weights are cast to the config's compute dtype at each use, as JAX casts
them; a tree already in that dtype (``transformer.compute_params``) makes
the casts no-ops. Norms run in fp32 and cast back.

Decode writes each row's new key and value into the cache in place at
that row's slot, for the rows ``rows`` names (all rows when None).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.knn_attention import knn_attention_decode_rows, knn_attention_mha
from repro_torch.models.config import ModelConfig
from repro_torch.models.module import spec

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# Norms


def norm_spec(cfg: ModelConfig, d: Optional[int] = None):
    d = d or cfg.d_model
    if cfg.norm == "rmsnorm":
        return {"scale": spec((d,), init="ones")}
    if cfg.norm == "layernorm":
        return {
            "scale": spec((d,), init="ones"),
            "bias": spec((d,), init="zeros"),
        }
    if cfg.norm == "nonparam_ln":  # OLMo: no learnable affine
        return {}
    raise ValueError(cfg.norm)


def norm_apply(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x32 = x.float()
    if cfg.norm == "rmsnorm":
        var = (x32 * x32).mean(-1, keepdim=True)
        out = x32 * torch.rsqrt(var + 1e-6) * params["scale"].float()
    else:
        mean = x32.mean(-1, keepdim=True)
        var = x32.var(-1, keepdim=True, correction=0)
        out = (x32 - mean) * torch.rsqrt(var + 1e-5)
        if cfg.norm == "layernorm":
            out = out * params["scale"].float() + params["bias"].float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings (standard + M-RoPE)


def _rope_freqs(dh_half: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(dh_half, dtype=torch.float32, device=device) / dh_half
    return 1.0 / (theta ** exps)


def rope_angles(positions: torch.Tensor, dh: int, theta: float,
                mrope_sections: Optional[tuple[int, ...]] = None) -> torch.Tensor:
    """positions: (B, S) or (3, B, S) for M-RoPE -> angles (B, S, dh//2)."""
    half = dh // 2
    freqs = _rope_freqs(half, theta, positions.device)  # (half,)
    if mrope_sections is None:
        return positions[..., None].float() * freqs  # (B,S,half)
    if positions.ndim != 3:
        raise ValueError("M-RoPE needs (3, B, S) position ids")
    if sum(mrope_sections) != half:
        raise ValueError(f"mrope_sections {mrope_sections} do not sum to {half}")
    parts = []
    start = 0
    for i, sec in enumerate(mrope_sections):
        f = freqs[start:start + sec]
        parts.append(positions[i][..., None].float() * f)
        start += sec
    return torch.cat(parts, dim=-1)  # (B, S, half)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, dh); angles: (B, S, dh//2). NeoX half-rotation."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (S, D), fp32."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


# ---------------------------------------------------------------------------
# Embedding / unembedding


def embed_spec(cfg: ModelConfig):
    s = {"tokens": spec((cfg.vocab_size, cfg.d_model), init="embed", scale=0.02)}
    if not cfg.tie_embeddings:
        s["unembed"] = spec((cfg.d_model, cfg.vocab_size), init="fanin")
    return s


def embed_apply(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return params["tokens"][tokens.long()].to(cfg.compute_dtype)


def unembed_apply(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    w = params["tokens"].T if cfg.tie_embeddings else params["unembed"]
    logits = x @ w.to(cfg.compute_dtype)
    if cfg.logit_softcap > 0:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


# ---------------------------------------------------------------------------
# MLP


def mlp_spec(cfg: ModelConfig, d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.activation == "swiglu":
        return {
            "wi_gate": spec((d, f)),
            "wi_up": spec((d, f)),
            "wo": spec((f, d)),
        }
    return {
        "wi": spec((d, f)),
        "bi": spec((f,), init="zeros"),
        "wo": spec((f, d)),
        "bo": spec((d,), init="zeros"),
    }


def mlp_apply(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = cfg.compute_dtype
    if cfg.activation == "swiglu":
        g = x @ params["wi_gate"].to(dt)
        u = x @ params["wi_up"].to(dt)
        return (F.silu(g) * u) @ params["wo"].to(dt)
    h = x @ params["wi"].to(dt) + params["bi"].to(dt)
    h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    return h @ params["wo"].to(dt) + params["bo"].to(dt)


# ---------------------------------------------------------------------------
# Attention (GQA / MQA, optional bias, qk-norm, local window, KNN)


def attention_spec(cfg: ModelConfig):
    d, h, kvh, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.dh
    s = {
        "wq": spec((d, h, dh)),
        "wk": spec((d, kvh, dh)),
        "wv": spec((d, kvh, dh)),
        "wo": spec((h, dh, d)),
    }
    if cfg.qkv_bias:
        s["bq"] = spec((h, dh), init="zeros")
        s["bk"] = spec((kvh, dh), init="zeros")
        s["bv"] = spec((kvh, dh), init="zeros")
    if cfg.qk_norm:
        s["q_norm"] = spec((dh,), init="ones")
        s["k_norm"] = spec((dh,), init="ones")
    return s


def _rms_head(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + 1e-6) * scale.float()).to(x.dtype)


def _proj_heads(x: torch.Tensor, w: torch.Tensor, dt) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, h, k = w.shape
    return (x @ w.to(dt).reshape(d, h * k)).unflatten(-1, (h, k))


def _out_proj(out: torch.Tensor, w: torch.Tensor, dt) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    h, k, d = w.shape
    return out.flatten(-2) @ w.to(dt).reshape(h * k, d)


def _qkv(params, x: torch.Tensor, cfg: ModelConfig, positions):
    dt = cfg.compute_dtype
    q = _proj_heads(x, params["wq"], dt)
    k = _proj_heads(x, params["wk"], dt)
    v = _proj_heads(x, params["wv"], dt)
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    if cfg.qk_norm:
        q = _rms_head(q, params["q_norm"])
        k = _rms_head(k, params["k_norm"])
    if cfg.rope_theta > 0:  # rope_theta == 0: absolute positions
        ang = rope_angles(positions, cfg.dh, cfg.rope_theta, cfg.mrope_sections)
        q = apply_rope(q, ang)
        k = apply_rope(k, ang)
    return q, k, v


def _repeat_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B,S,KVH,dh) -> (B,S,H,dh) by repetition for grouped-query attn."""
    kvh = k.shape[2]
    if kvh == num_heads:
        return k
    return k.repeat_interleave(num_heads // kvh, dim=2)


def mha_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool, window: int = 0, q_offset=0, kv_len=None,
                q_chunk: int = 512) -> torch.Tensor:
    """Memory-bounded exact attention: iterate query chunks, full softmax
    over keys per chunk. q: (B,Sq,H,dh), k/v: (B,Skv,KVH,dv).

    Grouped-query form: KV heads are never repeated; the einsum carries
    the (kv_head, group) split. ``q_offset``: absolute position of q[0]
    relative to k[0]. ``kv_len``: valid key prefix (masks the cache
    tail). Chunks hold ``q_chunk`` rows and the last one the rest, where
    JAX halves the chunk until it divides Sq (a row's result does not
    depend on its chunk): at whisper's 1500 encoder frames JAX's rule
    gives 375 chunks of 4 rows a layer (ROADMAP queue 3, item 21).
    """
    b, sq, h, dh = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    dv = v.shape[-1]
    scale = dh**-0.5
    qc = min(q_chunk, sq)
    kpos = torch.arange(skv, device=q.device)
    outs = []
    for start in range(0, sq, qc):
        n = min(qc, sq - start)
        qg = q[:, start:start + n].reshape(b, n, kvh, g, dh)
        logits = torch.einsum("bqkgd,btkd->bkgqt", qg, k).float() * scale
        qpos = q_offset + start + torch.arange(n, device=q.device)
        mask = torch.ones((n, skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window > 0:
            mask &= kpos[None, :] > qpos[:, None] - window
        if kv_len is not None:
            mask &= kpos[None, :] < kv_len
        logits = torch.where(mask, logits, NEG_INF)
        w = torch.softmax(logits, dim=-1).to(q.dtype)
        out = torch.einsum("bkgqt,btkd->bqkgd", w, v)
        outs.append(out.reshape(b, n, h, dv))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _pos_vector(pos, b: int, device) -> torch.Tensor:
    """A scalar or (B,) decode position as a (B,) int64 tensor."""
    return torch.as_tensor(pos, device=device).long().reshape(-1).expand(b)


def _write_rows(cache: dict, new: dict, slot: torch.Tensor, rows,
                vector: bool) -> None:
    """Write row r's new entries (``new[name]`` (B, 1, ...), e.g. the key
    and value) at cache slot ``slot[r]`` of ``cache[name]`` in place, for
    the rows ``rows`` names (all when None), bounded as JAX bounds it with
    no host read: a (B,) ``pos`` vector (``vector``) writes nothing for a
    row whose slot is outside [0, T) (JAX's ``hit`` mask is all false); a
    scalar ``pos`` clamps the write into [0, T - 1], as
    ``dynamic_update_slice`` does."""
    if rows is None:
        rows = torch.arange(slot.shape[0], device=slot.device)
    t = next(iter(cache.values())).shape[1]
    at = slot[rows]
    idx = at.clamp(0, t - 1)
    for name, val in new.items():
        val = val[rows, 0].to(cache[name].dtype)
        if vector:
            keep = ((at >= 0) & (at < t)).reshape((-1,) + (1,) * (val.ndim - 1))
            val = torch.where(keep, val, cache[name][rows, idx])
        cache[name][rows, idx] = val


def _is_vector(pos) -> bool:
    """A (B,) per-slot ``pos`` vector, as against a scalar."""
    return torch.as_tensor(pos).ndim == 1


def attention_apply(params, x: torch.Tensor, cfg: ModelConfig, *, positions,
                    cache: Optional[dict] = None, pos=None, rows=None,
                    memory: Optional[tuple] = None, causal: bool = True):
    """Full / local attention forward.

    prefill: cache=None -> (out, (k, v)) so callers may build caches.
    decode: cache={"k","v"} (B,T,KVH,dh) and ``pos``, a scalar or a (B,)
    per-slot vector: each row writes its new key/value at its own slot
    (``pos % T`` for local attention's rolling buffer) into ``cache`` in
    place, for the rows ``rows`` names (all when None), and attends up to
    its own position -> (out, cache).
    memory: (mk, mv) (B,S_enc,KVH,dh) for cross attention: q from x with
    its bias, the given keys and values, no RoPE -> (out, None).
    """
    dt = cfg.compute_dtype
    window = cfg.window if cfg.attention == "local" else 0

    if memory is not None:
        q = _proj_heads(x, params["wq"], dt)
        if cfg.qkv_bias:
            q = q + params["bq"].to(dt)
        k, v = memory
        out = mha_chunked(q, k, v, causal=False, q_chunk=cfg.q_chunk)
        return _out_proj(out, params["wo"], dt), None

    if cache is None:
        q, k, v = _qkv(params, x, cfg, positions)
        out = mha_chunked(q, k, v, causal=causal, window=window,
                          q_chunk=cfg.q_chunk)
        return _out_proj(out, params["wo"], dt), (k, v)

    q, k_new, v_new = _qkv(params, x, cfg, positions)
    b = q.shape[0]
    kvh, g = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    t = cache["k"].shape[1]
    pv = _pos_vector(pos, b, q.device)
    sv = pv % t if window > 0 else pv  # rolling buffer for local attention
    _write_rows(cache, {"k": k_new, "v": v_new}, sv, rows, _is_vector(pos))
    qg = q.reshape(b, 1, kvh, g, cfg.dh)
    logits = torch.einsum(
        "bqkgd,btkd->bkgqt", qg, cache["k"].to(dt)
    ).float() * cfg.dh**-0.5
    kpos = torch.arange(t, device=q.device)[None, :]
    pv, sv = pv[:, None], sv[:, None]  # (B, 1) against kpos (1, T)
    if window > 0:
        # slot s holds the absolute position derived from pos
        abs_pos = torch.where(kpos <= sv, pv - sv + kpos, pv - sv - t + kpos)
        mask = (abs_pos >= 0) & (abs_pos <= pv) & (abs_pos > pv - window)
    else:
        mask = kpos <= pv  # (B, T)
    logits = torch.where(mask[:, None, None, None, :], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(dt)
    out = torch.einsum("bkgqt,btkd->bqkgd", w, cache["v"].to(dt))
    out = out.reshape(b, 1, cfg.num_heads, cfg.dh)
    return _out_proj(out, params["wo"], dt), cache


def knn_attention_apply(params, x: torch.Tensor, cfg: ModelConfig, *,
                        positions, cache: Optional[dict] = None, pos=None,
                        rows=None):
    """DIGC-backed sparse attention (attention='knn'). Prefill: one causal
    DIGC over the (batch x heads) rows on the ``blocked`` tier; decode:
    the nearest cached keys of one distance row per (row, head), each row
    at its own cache length. Cache writes as ``attention_apply``."""
    dt = cfg.compute_dtype
    q, k, v = _qkv(params, x, cfg, positions)
    if cache is None:
        kk = _repeat_kv(k, cfg.num_heads)
        vv = _repeat_kv(v, cfg.num_heads)
        out = knn_attention_mha(q, kk, vv, num_neighbors=cfg.knn_neighbors,
                                causal=True)
        return _out_proj(out, params["wo"], dt), (k, v)
    pv = _pos_vector(pos, q.shape[0], q.device)
    _write_rows(cache, {"k": k, "v": v}, pv, rows, _is_vector(pos))
    kk = _repeat_kv(cache["k"].to(dt), cfg.num_heads)
    vv = _repeat_kv(cache["v"].to(dt), cfg.num_heads)
    out = knn_attention_decode_rows(q[:, 0], kk, vv, pv + 1,
                                    num_neighbors=cfg.knn_neighbors)  # (B,H,dh)
    return _out_proj(out[:, None], params["wo"], dt), cache
