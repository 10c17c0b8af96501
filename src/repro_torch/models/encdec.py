"""Whisper-style encoder-decoder backbone (port of ``repro/models/encdec.py``).

The audio frontend (conv1d stem over mel spectrograms) is a stub, as in
the JAX package: the caller supplies precomputed frame embeddings
(B, S_enc, d_model). The encoder adds sinusoidal positions; the decoder
uses a learned positional table, causal self-attention and cross
attention to the encoder memory, GELU MLPs, LayerNorm.

Parameters keep JAX's stacked tree (``enc`` and ``dec`` with a leading
layers dimension). The decode cache is ``{"k", "v"}`` (layers, B, T, KVH,
dh) for the decoder's self-attention and ``{"mk", "mv"}`` (layers, B,
S_enc, KVH, dh) for the memory's keys and values, in the compute dtype.
``encdec_decode_step`` writes each step's keys and values into the cache
in place (ROADMAP queue 3, item 14) and returns it.
"""

from __future__ import annotations

from typing import Mapping

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    _proj_heads,
    attention_apply,
    attention_spec,
    embed_apply,
    embed_spec,
    mlp_apply,
    mlp_spec,
    norm_apply,
    norm_spec,
    sinusoidal_positions,
    unembed_apply,
)
from repro_torch.models.module import spec
from repro_torch.models.transformer import _remat, _select, masked_nll, stack_specs

MAX_DEC_POS = 8192 * 8  # learned decoder positions (covers decode_32k)


def _enc_layer_spec(cfg: ModelConfig):
    return {
        "ln1": norm_spec(cfg),
        "attn": attention_spec(cfg),
        "ln2": norm_spec(cfg),
        "mlp": mlp_spec(cfg),
    }


def _dec_layer_spec(cfg: ModelConfig):
    return {
        "ln1": norm_spec(cfg),
        "self_attn": attention_spec(cfg),
        "ln2": norm_spec(cfg),
        "cross_attn": attention_spec(cfg),
        "ln3": norm_spec(cfg),
        "mlp": mlp_spec(cfg),
    }


def encdec_param_spec(cfg: ModelConfig):
    return {
        "embed": embed_spec(cfg),
        "dec_pos": spec((MAX_DEC_POS, cfg.d_model), (None, "embed"),
                        init="normal"),
        "enc": stack_specs(_enc_layer_spec(cfg), cfg.encdec.enc_layers),
        "enc_norm": norm_spec(cfg),
        "dec": stack_specs(_dec_layer_spec(cfg), cfg.num_layers),
        "final_norm": norm_spec(cfg),
    }


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def _enc_body(lp, h, cfg: ModelConfig, positions):
    a, _ = attention_apply(lp["attn"], norm_apply(lp["ln1"], h, cfg), cfg,
                           positions=positions, causal=False)
    h = h + a
    return h + mlp_apply(lp["mlp"], norm_apply(lp["ln2"], h, cfg), cfg)


def encode(params, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames (B, S_enc, D) precomputed embeddings -> memory (B, S_enc, D)."""
    b, s, d = frames.shape
    dt = cfg.compute_dtype
    x = frames.to(dt) + sinusoidal_positions(s, d, frames.device).to(dt)
    positions = _positions(b, s, frames.device)
    body = _remat(_enc_body, cfg)
    for i in range(cfg.encdec.enc_layers):
        x = body(_select(params["enc"], (), i), x, cfg, positions)
    return norm_apply(params["enc_norm"], x, cfg)


def _memory_kv(lp, memory: torch.Tensor, cfg: ModelConfig):
    """The cross attention's keys and values of the memory, (B, S_enc,
    KVH, dh) each."""
    dt = cfg.compute_dtype
    mk = _proj_heads(memory, lp["cross_attn"]["wk"], dt)
    mv = _proj_heads(memory, lp["cross_attn"]["wv"], dt)
    if cfg.qkv_bias:
        mk = mk + lp["cross_attn"]["bk"].to(dt)
        mv = mv + lp["cross_attn"]["bv"].to(dt)
    return mk, mv


def _dec_body(lp, h, memory, cfg: ModelConfig, positions):
    a, kv = attention_apply(lp["self_attn"], norm_apply(lp["ln1"], h, cfg),
                            cfg, positions=positions)
    h = h + a
    mk, mv = _memory_kv(lp, memory, cfg)
    c, _ = attention_apply(lp["cross_attn"], norm_apply(lp["ln2"], h, cfg),
                           cfg, positions=positions, memory=(mk, mv))
    h = h + c
    h = h + mlp_apply(lp["mlp"], norm_apply(lp["ln3"], h, cfg), cfg)
    return h, kv, (mk, mv)


def decode_forward(params, tokens: torch.Tensor, memory: torch.Tensor,
                   cfg: ModelConfig, *, return_cache: bool = False):
    """Teacher-forced decoder pass. tokens (B, S_dec) -> logits (B, S_dec,
    V) [, (self_kv, mem_kv): (k, v) and (mk, mv), each stacked over the
    layers, when ``return_cache``]."""
    b, s = tokens.shape
    x = embed_apply(params["embed"], tokens, cfg)
    x = x + params["dec_pos"][:s].to(cfg.compute_dtype)
    positions = _positions(b, s, tokens.device)
    body = _remat(_dec_body, cfg)
    self_kv, mem_kv = [], []
    for i in range(cfg.num_layers):
        x, kv, mkv = body(_select(params["dec"], (), i), x, memory, cfg, positions)
        if return_cache:
            self_kv.append(kv)
            mem_kv.append(mkv)
    x = norm_apply(params["final_norm"], x, cfg)
    logits = unembed_apply(params["embed"], x, cfg)
    if return_cache:
        stack = lambda entries: tuple(torch.stack(t) for t in zip(*entries))
        return logits, (stack(self_kv), stack(mem_kv))
    return logits


def encdec_loss_fn(params, batch: Mapping, cfg: ModelConfig):
    """batch: frames (B, S_enc, D), tokens (B, S_dec), labels, mask ->
    (masked mean NLL, {})."""
    memory = encode(params, batch["frames"], cfg)
    return masked_nll(decode_forward(params, batch["tokens"], memory, cfg),
                      batch), {}


def encdec_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                      enc_len: int, *, device="cuda") -> dict:
    """Zeroed decode cache in the compute dtype."""
    dev = resolve_device(device)
    lead = (cfg.num_layers, batch)
    tail = (cfg.num_kv_heads, cfg.dh)
    shapes = {"k": lead + (max_len,) + tail, "v": lead + (max_len,) + tail,
              "mk": lead + (enc_len,) + tail, "mv": lead + (enc_len,) + tail}
    return {name: torch.zeros(shape, dtype=cfg.compute_dtype, device=dev)
            for name, shape in shapes.items()}


def encdec_decode_step(params, cache: dict, tokens: torch.Tensor, pos,
                       cfg: ModelConfig):
    """One decoder token (B, 1) at scalar position ``pos`` against the
    self-attention cache and the precomputed memory keys and values ->
    (logits (B, 1, V), cache). Each layer's new key and value are written
    into ``cache`` in place at row ``pos`` (clamped into the cache, as
    JAX's ``dynamic_update_slice``); the learned position is
    ``dec_pos[pos]`` (clamped likewise)."""
    b = tokens.shape[0]
    dt = cfg.compute_dtype
    pos = torch.as_tensor(pos, device=tokens.device)
    row = pos.long().clamp(0, params["dec_pos"].shape[0] - 1).reshape(1)
    x = embed_apply(params["embed"], tokens, cfg)
    x = x + params["dec_pos"].index_select(0, row).to(dt)
    positions = pos.to(torch.int32).reshape(1, 1).expand(b, 1)
    for i in range(cfg.num_layers):
        lp = _select(params["dec"], (), i)
        a, _ = attention_apply(lp["self_attn"], norm_apply(lp["ln1"], x, cfg),
                               cfg, positions=positions,
                               cache={"k": cache["k"][i], "v": cache["v"][i]},
                               pos=pos)
        x = x + a
        c, _ = attention_apply(lp["cross_attn"], norm_apply(lp["ln2"], x, cfg),
                               cfg, positions=positions,
                               memory=(cache["mk"][i].to(dt),
                                       cache["mv"][i].to(dt)))
        x = x + c
        x = x + mlp_apply(lp["mlp"], norm_apply(lp["ln3"], x, cfg), cfg)
    x = norm_apply(params["final_norm"], x, cfg)
    return unembed_apply(params["embed"], x, cfg), cache
