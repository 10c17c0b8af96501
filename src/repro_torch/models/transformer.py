"""Decoder-only LM assembly (port of ``repro/models/transformer.py``) for the
families ``dense`` (olmo, qwen1.5, qwen3, granite), ``vlm`` (qwen2-vl's
M-RoPE backbone) and ``moe`` (qwen3-moe: routed MoE with GQA; deepseek-v2:
MLA and MoE with shared experts), with full, local and KNN attention.

Parameters keep JAX's stacked layout: every per-layer leaf carries a
leading ``layers`` dimension, so converting a JAX tree is one-to-one; a
Python loop walks it where JAX scans. SSM, the Griffin hybrid and the
encoder-decoder raise ``NotImplementedError`` naming the ROADMAP item
that ports them; nothing runs them as dense.

Decode cache, in the compute dtype with a leading ``layers`` dim:
``{"k", "v"}`` of (layers, B, T, KVH, dh) (T = ``min(window, max_len)``
for local attention's rolling buffer), or MLA's latent
``{"c_kv": (layers, B, T, kv_lora), "k_pe": (layers, B, T, rope)}``.
``decode_step`` is functional by default (the cache passed in is left as
it was); ``rows=`` writes the named rows' new entries into the given
cache in place instead and leaves every other row bit for bit as it was,
the serving engine's commit.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    attention_apply,
    attention_spec,
    embed_apply,
    embed_spec,
    knn_attention_apply,
    mlp_apply,
    mlp_spec,
    norm_apply,
    norm_spec,
    unembed_apply,
)
from repro_torch.models.mla import mla_apply, mla_spec
from repro_torch.models.module import ParamSpec, map_tree
from repro_torch.models.moe import moe_apply, moe_spec

# ROADMAP queue 1 items that port the families this module refuses.
_UNPORTED = (
    (lambda c: c.family == "ssm", "the SSM family (models/ssm.py)", "7c"),
    (lambda c: c.family == "hybrid", "the Griffin hybrid (models/griffin.py)", "7d"),
    (lambda c: c.family in ("audio", "encdec"),
     "the encoder-decoder (models/encdec.py)", "7e"),
)
# Leaves JAX uses in fp32 (norm scales and biases; the MoE router, which
# multiplies fp32 tokens; MLA's latent norm): never cast.
_FP32_KEYS = {"ln1", "ln2", "final_norm", "q_norm", "k_norm", "kv_norm",
              "router"}
_FAMILIES = ("dense", "vlm", "moe")


def check_ported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a config this port cannot run."""
    for hit, what, item in _UNPORTED:
        if hit(cfg):
            raise NotImplementedError(
                f"{cfg.name!r}: {what} is not ported yet (ROADMAP queue 1, "
                f"item {item}); the port runs families {_FAMILIES}")
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"{cfg.name!r}: family {cfg.family!r} is not ported; the port "
            f"runs families {_FAMILIES}")


# ---------------------------------------------------------------------------
# Param specs


def stack_specs(tree, n: int):
    return map_tree(lambda _, s: ParamSpec((n,) + s.shape, s.init, s.scale,
                                           s.dtype), tree)


def _layer_kind(cfg: ModelConfig) -> str:
    return "attn_moe" if cfg.moe else "attn"


def _layer_spec(cfg: ModelConfig):
    """One residual layer: temporal mixer + channel mixer."""
    return {"ln1": norm_spec(cfg), "ln2": norm_spec(cfg),
            "mix": mla_spec(cfg) if cfg.mla else attention_spec(cfg),
            "mlp": moe_spec(cfg) if _layer_kind(cfg) == "attn_moe"
            else mlp_spec(cfg)}


def param_spec(cfg: ModelConfig):
    check_ported(cfg)
    return {"embed": embed_spec(cfg), "final_norm": norm_spec(cfg),
            "layers": stack_specs(_layer_spec(cfg), cfg.num_layers)}


def compute_dtype(path: tuple, cfg: ModelConfig) -> torch.dtype:
    """The dtype the compute tree holds the floating leaf at ``path`` in:
    fp32 for the leaves JAX uses in fp32 (``_FP32_KEYS``), the compute
    dtype for every other (the weights, biases and embedding JAX casts at
    use)."""
    if any(key in _FP32_KEYS for key in path):
        return torch.float32
    return cfg.compute_dtype


def compute_params(params, cfg: ModelConfig, device=None):
    """The tree with every leaf in its ``compute_dtype``, on ``device`` when
    given: the values the per-use casts give. A leaf already in its dtype
    and on its device is kept as it is, not copied."""
    dev = None if device is None else resolve_device(device)

    def one(path, t):
        dt = compute_dtype(path, cfg) if t.is_floating_point() else None
        return t.to(device=dev, dtype=dt)

    return map_tree(one, params)


# ---------------------------------------------------------------------------
# Blocks


def _layer(params, i: int):
    """Layer ``i``'s parameters: views into the stacked leaves."""
    return map_tree(lambda _, t: t[i], params["layers"])


def _apply_mixer(lp, x, cfg: ModelConfig, *, positions, cache=None, pos=None,
                 rows=None):
    """Temporal mixing sublayer. Returns (out, cache_entry)."""
    if cfg.mla:
        return mla_apply(lp["mix"], x, cfg, positions=positions, cache=cache,
                         pos=pos, rows=rows)
    if cfg.attention == "knn":
        return knn_attention_apply(lp["mix"], x, cfg, positions=positions,
                                   cache=cache, pos=pos, rows=rows)
    return attention_apply(lp["mix"], x, cfg, positions=positions, cache=cache,
                           pos=pos, rows=rows)


def _block(lp, x, cfg: ModelConfig, *, positions, cache=None, pos=None,
           rows=None):
    """One residual layer: x + mixer(norm(x)); x + mlp(norm(x)). Returns
    (x, cache_entry, metrics): the MoE layer's ``moe_aux`` and
    ``moe_drop_frac``, empty for a dense MLP."""
    h = norm_apply(lp["ln1"], x, cfg)
    mix_out, cache_entry = _apply_mixer(lp, h, cfg, positions=positions,
                                        cache=cache, pos=pos, rows=rows)
    x = x + mix_out
    h = norm_apply(lp["ln2"], x, cfg)
    if _layer_kind(cfg) == "attn_moe":
        mlp_out, metrics = moe_apply(lp["mlp"], h, cfg)
    else:
        mlp_out, metrics = mlp_apply(lp["mlp"], h, cfg), {}
    return x + mlp_out, cache_entry, metrics


# ---------------------------------------------------------------------------
# Forward (prefill)


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, *, positions=None,
            return_cache: bool = False):
    """tokens (B,S) -> (logits (B,S,V), metrics) [with the stacked layer
    caches, (k, v) or MLA's (c_kv, k_pe), between them when
    ``return_cache``]. ``metrics``: ``moe_aux`` summed over the layers and
    ``moe_drop_frac`` their mean, fp32 scalars (zero without MoE), as
    JAX's."""
    check_ported(cfg)
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device).expand(b, s)
        if cfg.mrope_sections:
            positions = positions.expand(3, b, s)
    x = embed_apply(params["embed"], tokens, cfg)
    entries, auxs, drops = [], [], []
    zero = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for i in range(cfg.num_layers):
        x, entry, metrics = _block(_layer(params, i), x, cfg,
                                   positions=positions)
        if return_cache:
            entries.append(entry)
        auxs.append(metrics.get("moe_aux", zero))
        drops.append(metrics.get("moe_drop_frac", zero))
    x = norm_apply(params["final_norm"], x, cfg)
    logits = unembed_apply(params["embed"], x, cfg)
    metrics = {"moe_aux": torch.stack(auxs).sum(),
               "moe_drop_frac": torch.stack(drops).mean()}
    if return_cache:
        caches = tuple(torch.stack(parts) for parts in zip(*entries))
        return logits, caches, metrics
    return logits, metrics


# ---------------------------------------------------------------------------
# KV caches + decode


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda"):
    """Zeroed decode cache with a leading ``layers`` dim."""
    check_ported(cfg)
    lead = (cfg.num_layers, batch)
    if cfg.mla:
        m = cfg.mla
        shapes = {"c_kv": lead + (max_len, m.kv_lora),
                  "k_pe": lead + (max_len, m.qk_rope_dim)}
    else:
        t = max_len if cfg.attention != "local" else min(cfg.window, max_len)
        shapes = dict.fromkeys(("k", "v"),
                               lead + (t, cfg.num_kv_heads, cfg.dh))
    dev = resolve_device(device)
    return {name: torch.zeros(shape, dtype=cfg.compute_dtype, device=dev)
            for name, shape in shapes.items()}


def decode_step(params, cache, tokens: torch.Tensor, pos, cfg: ModelConfig, *,
                positions=None, rows: Optional[torch.Tensor] = None):
    """One decode step. tokens (B,1); ``pos`` a scalar (write slot and
    absolute position of every row) or a (B,) per-slot vector: a
    mixed-length slot batch decodes in one call, each row writing its
    cache at (and attending up to) its own position. Returns (logits
    (B,1,V), new cache).

    ``rows=None``: functional, the returned cache is a new one. ``rows``
    (int64 row ids): those rows' cache entries (keys and values, or MLA's
    latents) are written into ``cache`` in place and it is returned;
    other rows' caches are left bit for bit and their logits are
    unspecified.
    """
    check_ported(cfg)
    b = tokens.shape[0]
    pos = torch.as_tensor(pos, device=tokens.device)
    if positions is None:
        positions = pos.to(torch.int32).reshape(-1, 1).expand(b, 1)
        if cfg.mrope_sections:
            positions = positions.expand(3, b, 1)
    if rows is None:
        cache = {name: t.clone() for name, t in cache.items()}
    x = embed_apply(params["embed"], tokens, cfg)
    for i in range(cfg.num_layers):
        layer_cache = {name: t[i] for name, t in cache.items()}
        x, _, _ = _block(_layer(params, i), x, cfg, positions=positions,
                         cache=layer_cache, pos=pos, rows=rows)
    x = norm_apply(params["final_norm"], x, cfg)
    return unembed_apply(params["embed"], x, cfg), cache


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, *,
            max_len: Optional[int] = None, positions=None):
    """Run the prompt, return (logits, cache ready for decode_step at
    pos = S)."""
    logits, caches, _ = forward(params, tokens, cfg, positions=positions,
                                return_cache=True)
    s = tokens.shape[1]
    max_len = max_len or s
    if cfg.mla:
        pad = max_len - s
        c, kp = (F.pad(t, (0, 0, 0, pad)) if pad > 0 else t for t in caches)
        return logits, {"c_kv": c, "k_pe": kp}
    k, v = caches
    window = cfg.window if cfg.attention == "local" else 0
    # stacked caches have a leading `layers` dim: seq axis is 2.
    if window:
        k, v = k[:, :, -window:], v[:, :, -window:]
        tgt = min(window, max_len)
    else:
        tgt = max_len
    pad = tgt - k.shape[2]
    if pad > 0:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    return logits, {"k": k, "v": v}

