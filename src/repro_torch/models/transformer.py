"""Decoder-only LM assembly (port of ``repro/models/transformer.py``) for the
families ``dense`` (olmo, qwen1.5, qwen3, granite), ``vlm`` (qwen2-vl's
M-RoPE backbone), ``moe`` (qwen3-moe: routed MoE with GQA; deepseek-v2:
MLA and MoE with shared experts), ``ssm`` (mamba2: SSD blocks with no
channel mixer) and ``hybrid`` (recurrentgemma: RG-LRU and local attention
in (rec, rec, attn) groups), with full, local and KNN attention.

Parameters keep JAX's stacked layout: every per-layer leaf carries a
leading ``layers`` dimension (the hybrid: ``groups``, stacked over the
groups with keys ``l{i}_{kind}``, then the unstacked remainder ``rem``
of ``l{i}_rec`` layers), so converting a JAX tree is one-to-one; a Python
loop walks it where JAX scans. A published DeepSeek-V2
(``DeepSeekV2Config``) stacks its ``dense_layers`` leading layers, each
with a dense SwiGLU of width ``dense_d_ff``, under ``dense`` ahead of the
MoE layers under ``layers``; its decode cache stays one stack over every
layer. The encoder-decoder (family ``audio``) is
``models/encdec.py``. ``loss_fn`` is the training loss; under autograd
each layer body follows the config's remat policy (``_remat``).

Decode cache, with the parameters' leading dims: ``{"k", "v"}`` of
(layers, B, T, KVH, dh) in the compute dtype (T = ``min(window,
max_len)`` for local attention's rolling buffer), MLA's latent
``{"c_kv": (layers, B, T, kv_lora), "k_pe": (layers, B, T, rope)}``, the
SSM's fp32 state ``{"h": (layers, B, H, N, P), "conv": (layers, B, K-1,
conv_dim)}``, or the hybrid's ``{"groups": {name: entry}, "rem": {name:
entry}}`` (batch axis 1 in ``groups``, 0 in ``rem``; fp32 RG-LRU states
``{"h", "conv"}``, attention ``{"k", "v"}``). ``decode_step`` is
functional by default (the cache passed in is left as it was); ``rows=``
commits the named rows into the given cache in place instead (an
attention row's new entry at its slot, a recurrent row's state whole) and
leaves every other row bit for bit as it was, the serving engine's
commit.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.griffin import rglru_apply, rglru_init_state, rglru_spec
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
from repro_torch.models.ssm import ssm_apply, ssm_init_state, ssm_spec

# Leaves JAX uses in fp32, never cast: norm scales and biases (the
# encoder-decoder's ``ln3`` and ``enc_norm`` too); the MoE router, which
# multiplies fp32 tokens; MLA's latent norm; the SSM's decay, step bias,
# skip and gated-norm scale (``norm``, a leaf only there: the layer norms
# are ``ln1`` / ``ln2`` / ``final_norm``); the RG-LRU's fp32 gates.
_FP32_KEYS = {"ln1", "ln2", "ln3", "enc_norm", "final_norm", "q_norm",
              "k_norm", "kv_norm",
              "router", "a_log", "dt_bias", "d_skip", "norm",
              "w_input_gate", "b_input_gate", "w_rec_gate", "b_rec_gate",
              "lam"}
_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")


def check_ported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a config this port cannot run."""
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"{cfg.name!r}: family {cfg.family!r} is not ported; the port "
            f"runs families {_FAMILIES}")


# ---------------------------------------------------------------------------
# Param specs


def stack_specs(tree, n: int):
    return map_tree(lambda _, s: ParamSpec(
        (n,) + s.shape, s.init, s.scale, s.dtype,
        None if s.axes is None else ("layers",) + s.axes), tree)


def _layer_kind(cfg: ModelConfig) -> str:
    if cfg.family == "ssm":
        return "ssm"
    return "attn_moe" if cfg.moe else "attn"


def _dense_layers(cfg: ModelConfig) -> int:
    """Leading layers with a dense MLP ahead of the MoE stack
    (``DeepSeekV2Config.dense_layers``; 0 for JAX's configs)."""
    return getattr(cfg, "dense_layers", 0)


def _mixer_layer_spec(cfg: ModelConfig, kind: str, d_ff: Optional[int] = None):
    """One residual layer: temporal mixer + channel mixer (a dense MLP of
    width ``d_ff``, default the config's)."""
    if kind == "ssm":
        return {"ln1": norm_spec(cfg), "ssm": ssm_spec(cfg)}
    if kind == "rec":
        mix = rglru_spec(cfg)
    else:
        mix = mla_spec(cfg) if cfg.mla else attention_spec(cfg)
    return {"ln1": norm_spec(cfg), "ln2": norm_spec(cfg), "mix": mix,
            "mlp": moe_spec(cfg) if kind == "attn_moe" else mlp_spec(cfg, d_ff)}


def _hybrid_layout(cfg: ModelConfig):
    """(pattern, groups, remainder layers) of a hybrid stack."""
    pat = cfg.hybrid.pattern
    n_groups = cfg.num_layers // len(pat)
    return pat, n_groups, cfg.num_layers - n_groups * len(pat)


def param_spec(cfg: ModelConfig):
    check_ported(cfg)
    p = {"embed": embed_spec(cfg), "final_norm": norm_spec(cfg)}
    if cfg.family == "hybrid":
        pat, n_groups, rem = _hybrid_layout(cfg)
        group = {f"l{i}_{kind}": _mixer_layer_spec(cfg, "rec" if kind == "rec"
                                                   else "attn")
                 for i, kind in enumerate(pat)}
        p["groups"] = stack_specs(group, n_groups)
        if rem:
            p["rem"] = {f"l{i}_rec": _mixer_layer_spec(cfg, "rec")
                        for i in range(rem)}
        return p
    n_dense = _dense_layers(cfg)
    if n_dense:
        p["dense"] = stack_specs(_mixer_layer_spec(cfg, "attn", cfg.dense_d_ff),
                                 n_dense)
    p["layers"] = stack_specs(_mixer_layer_spec(cfg, _layer_kind(cfg)),
                              cfg.num_layers - n_dense)
    return p


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


def _layers(cfg: ModelConfig) -> list:
    """Every layer in order as (kind, keys, index): the layer's parameters
    are the tree at ``keys`` under the stack's root (the parameters'
    ``layers`` dict, or the whole tree for the hybrid and for a config
    with dense leading layers), at ``index`` on its leading axis (None:
    unstacked, a ``rem`` layer). The hybrid's cache entries lie at the
    same place in its cache; every other cache is one stack over the
    layers in this order (``_cache_entry``)."""
    n_dense = _dense_layers(cfg)
    if n_dense:
        return ([("attn", ("dense",), i) for i in range(n_dense)]
                + [(_layer_kind(cfg), ("layers",), i)
                   for i in range(cfg.num_layers - n_dense)])
    if cfg.family != "hybrid":
        return [(_layer_kind(cfg), (), i) for i in range(cfg.num_layers)]
    pat, n_groups, rem = _hybrid_layout(cfg)
    out = [(kind, ("groups", f"l{i}_{kind}"), g)
           for g in range(n_groups) for i, kind in enumerate(pat)]
    return out + [("rec", ("rem", f"l{i}_rec"), None) for i in range(rem)]


def _map(fn, tree):
    """``fn`` over the tensors of a nested tree of dicts and tuples."""
    if isinstance(tree, Mapping):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_map(fn, v) for v in tree)
    return fn(tree)


def _select(tree, keys: tuple, index: Optional[int]):
    """The subtree at ``keys``, as views at ``index`` of its leading axis."""
    for key in keys:
        tree = tree[key]
    return tree if index is None else _map(lambda t: t[index], tree)


def _stack_root(params, cfg: ModelConfig):
    if cfg.family == "hybrid" or _dense_layers(cfg):
        return params
    return params["layers"]


def _cache_entry(cache, cfg: ModelConfig, n: int, keys: tuple,
                 index: Optional[int]):
    """Layer ``n``'s cache entry (its place ``keys``, ``index`` in
    ``_layers``)."""
    if cfg.family == "hybrid":
        return _select(cache, keys, index)
    return _select(cache, (), n)


def _layer(params, i: int, cfg: ModelConfig):
    """(kind, parameters) of layer ``i`` in the stack's order: views into
    the stacked leaves."""
    kind, keys, index = _layers(cfg)[i]
    return kind, _select(_stack_root(params, cfg), keys, index)


def _recurrent(apply, params, x, cfg: ModelConfig, cache, rows):
    """A recurrent mixer (``ssm_apply``, ``rglru_apply``). Decode computes
    every row's new state and writes it into ``cache`` in place, whole, for
    the rows ``rows`` names (all when None), as JAX's engine commits its
    member rows (``_merge_cache_rows``)."""
    out, new = apply(params, x, cfg, state=cache)
    if cache is None:
        return out, new
    for name, t in cache.items():
        if rows is None:
            t.copy_(new[name])
        else:
            t[rows] = new[name][rows]
    return out, cache


def _apply_mixer(lp, x, cfg: ModelConfig, kind: str, *, positions, cache=None,
                 pos=None, rows=None):
    """Temporal mixing sublayer. Returns (out, cache_entry)."""
    if kind == "ssm":
        return _recurrent(ssm_apply, lp["ssm"], x, cfg, cache, rows)
    if kind == "rec":
        return _recurrent(rglru_apply, lp["mix"], x, cfg, cache, rows)
    if cfg.mla:
        return mla_apply(lp["mix"], x, cfg, positions=positions, cache=cache,
                         pos=pos, rows=rows)
    if cfg.attention == "knn":
        return knn_attention_apply(lp["mix"], x, cfg, positions=positions,
                                   cache=cache, pos=pos, rows=rows)
    return attention_apply(lp["mix"], x, cfg, positions=positions, cache=cache,
                           pos=pos, rows=rows)


def _block(lp, x, cfg: ModelConfig, kind: str, *, positions, cache=None,
           pos=None, rows=None, live=None):
    """One residual layer: x + mixer(norm(x)); x + mlp(norm(x)) (none for
    an SSM layer). Returns (x, cache_entry, metrics): the MoE layer's
    ``moe_aux`` and ``moe_drop_frac``, empty for a dense MLP. ``live``
    (B,) bool or None goes to the MoE (``moe_apply``)."""
    h = norm_apply(lp["ln1"], x, cfg)
    mix_out, cache_entry = _apply_mixer(lp, h, cfg, kind, positions=positions,
                                        cache=cache, pos=pos, rows=rows)
    x = x + mix_out
    if kind == "ssm":  # mamba2 blocks have no separate channel mixer
        return x, cache_entry, {}
    h = norm_apply(lp["ln2"], x, cfg)
    if kind == "attn_moe":
        mlp_out, metrics = moe_apply(lp["mlp"], h, cfg, live=live)
    else:
        mlp_out, metrics = mlp_apply(lp["mlp"], h, cfg), {}
    return x + mlp_out, cache_entry, metrics


def _save_products(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep the outputs of
    matrix products without batch dimensions (``x @ W`` lowers to
    ``aten.mm``), recompute the rest, as JAX's
    ``dots_with_no_batch_dims_saveable`` (the attention's batched einsums
    lower to ``aten.bmm`` and are recomputed)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig):
    """A layer body under the config's remat policy, as JAX's ``_remat``:
    ``"none"`` keeps every activation; ``"full"`` keeps the body's inputs
    and recomputes the rest in the backward; ``"dots"`` keeps the matrix
    products' outputs too (``_save_products``). Applied only while
    autograd records: a forward without grad runs ``fn`` as it is."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(
            _save_products)
    return lambda *args, **kwargs: checkpoint(fn, *args, use_reentrant=False,
                                              **kw, **kwargs)


# ---------------------------------------------------------------------------
# Forward (prefill)


def _stack_entries(entries: list):
    """Per-layer cache entries, (k, v)-like tuples or state dicts, stacked
    on a new leading axis."""
    if isinstance(entries[0], Mapping):
        return {k: torch.stack([e[k] for e in entries]) for k in entries[0]}
    return tuple(torch.stack(parts) for parts in zip(*entries))


def _gather_caches(cfg: ModelConfig, layers: list, entries: list):
    """The prefill caches in JAX's tree: stacked over the layers, or the
    hybrid's ``{"groups": {name: stacked}, "rem": {name: entry}}``."""
    if cfg.family != "hybrid":
        return _stack_entries(entries)
    tree = {"groups": {}, "rem": {}}
    for (_, (top, name), _), entry in zip(layers, entries):
        tree[top].setdefault(name, []).append(entry)
    return {"groups": {n: _stack_entries(es) for n, es in tree["groups"].items()},
            "rem": {n: es[0] for n, es in tree["rem"].items()}}


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, *, positions=None,
            return_cache: bool = False):
    """tokens (B,S) -> (logits (B,S,V), metrics) [with the layer caches
    between them when ``return_cache``: stacked (k, v) or MLA's (c_kv,
    k_pe), the SSM's stacked {"h", "conv"}, or the hybrid's {"groups",
    "rem"} tree with raw (k, v) attention entries, as JAX's]. ``metrics``:
    ``moe_aux`` summed over the layers and ``moe_drop_frac`` their mean,
    fp32 scalars (zero without MoE), as JAX's."""
    check_ported(cfg)
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device).expand(b, s)
        if cfg.mrope_sections:
            positions = positions.expand(3, b, s)
    x = embed_apply(params["embed"], tokens, cfg)
    root, layers = _stack_root(params, cfg), _layers(cfg)
    entries, auxs, drops = [], [], []
    zero = torch.zeros((), dtype=torch.float32, device=tokens.device)
    block = _remat(_block, cfg)
    for kind, keys, index in layers:
        x, entry, metrics = block(_select(root, keys, index), x, cfg, kind,
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
        return logits, _gather_caches(cfg, layers, entries), metrics
    return logits, metrics


# ---------------------------------------------------------------------------
# Loss


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token cross entropy: the fp32 logsumexp minus the gold logit
    (a gather, where JAX sums an iota match; the same value)."""
    lf = logits.float()
    gold = lf.gather(-1, labels.long()[..., None])[..., 0]
    return torch.logsumexp(lf, dim=-1) - gold


def masked_nll(logits: torch.Tensor, batch: Mapping) -> torch.Tensor:
    """The mean of ``softmax_xent`` against ``batch["labels"]`` over the
    tokens ``batch["mask"]`` keeps (all when absent)."""
    nll = softmax_xent(logits, batch["labels"])
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(nll)
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def loss_fn(params, batch: Mapping, cfg: ModelConfig):
    """batch: tokens (B,S), labels (B,S), mask (B,S) [positions] ->
    (masked mean NLL + 0.01 x ``moe_aux``, metrics)."""
    logits, metrics = forward(params, batch["tokens"], cfg,
                              positions=batch.get("positions"))
    return masked_nll(logits, batch) + 0.01 * metrics["moe_aux"], metrics


# ---------------------------------------------------------------------------
# KV / state caches + decode


def _attn_cache(cfg: ModelConfig, lead: tuple, max_len: int, dev) -> dict:
    if cfg.mla:
        m = cfg.mla
        shapes = {"c_kv": lead + (max_len, m.kv_lora),
                  "k_pe": lead + (max_len, m.qk_rope_dim)}
    else:
        t = max_len if cfg.attention != "local" else min(cfg.window, max_len)
        shapes = dict.fromkeys(("k", "v"), lead + (t, cfg.num_kv_heads, cfg.dh))
    return {name: torch.zeros(shape, dtype=cfg.compute_dtype, device=dev)
            for name, shape in shapes.items()}


def _stacked(state: dict, n: int) -> dict:
    return {name: t.new_zeros((n,) + tuple(t.shape)) for name, t in state.items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda"):
    """Zeroed decode cache with the parameters' leading dims: attention in
    the compute dtype, recurrent states in fp32."""
    check_ported(cfg)
    dev = resolve_device(device)
    if cfg.family == "ssm":
        return _stacked(ssm_init_state(cfg, batch, device=dev), cfg.num_layers)
    if cfg.family == "hybrid":
        pat, n_groups, rem = _hybrid_layout(cfg)
        groups = {
            f"l{i}_{kind}": _stacked(rglru_init_state(cfg, batch, device=dev),
                                     n_groups) if kind == "rec"
            else _attn_cache(cfg, (n_groups, batch), max_len, dev)
            for i, kind in enumerate(pat)}
        return {"groups": groups,
                "rem": {f"l{i}_rec": rglru_init_state(cfg, batch, device=dev)
                        for i in range(rem)}}
    return _attn_cache(cfg, (cfg.num_layers, batch), max_len, dev)


def decode_step(params, cache, tokens: torch.Tensor, pos, cfg: ModelConfig, *,
                positions=None, rows: Optional[torch.Tensor] = None,
                live: Optional[torch.Tensor] = None):
    """One decode step. tokens (B,1); ``pos`` a scalar (write slot and
    absolute position of every row) or a (B,) per-slot vector: a
    mixed-length slot batch decodes in one call, each row writing its
    cache at (and attending up to) its own position; recurrent layers
    ignore it. Returns (logits (B,1,V), new cache).

    ``rows=None``: functional, the returned cache is a new one (the whole
    tree cloned). ``rows`` (int64 row ids): those rows' cache entries
    (keys and values, MLA's latents, or a recurrent layer's whole state)
    are written into ``cache`` in place and it is returned; other rows'
    caches are left bit for bit and their logits are unspecified.

    ``live`` (B,) bool or None (every row): the rows the caller reads. A
    dead row enters no routed expert group (its MoE output is the shared
    experts' alone) and its logits are unspecified; a live row's values do
    not depend on which other rows are live.
    """
    check_ported(cfg)
    b = tokens.shape[0]
    pos = torch.as_tensor(pos, device=tokens.device)
    if positions is None:
        positions = pos.to(torch.int32).reshape(-1, 1).expand(b, 1)
        if cfg.mrope_sections:
            positions = positions.expand(3, b, 1)
    if rows is None:
        cache = _map(torch.clone, cache)
    x = embed_apply(params["embed"], tokens, cfg)
    root = _stack_root(params, cfg)
    for n, (kind, keys, index) in enumerate(_layers(cfg)):
        x, _, _ = _block(_select(root, keys, index), x, cfg, kind,
                         positions=positions,
                         cache=_cache_entry(cache, cfg, n, keys, index),
                         pos=pos, rows=rows, live=live)
    x = norm_apply(params["final_norm"], x, cfg)
    return unembed_apply(params["embed"], x, cfg), cache


def prefills_into_rows(cfg: ModelConfig) -> bool:
    """Whether ``prefill_into`` serves ``cfg``: a cache that is a stack of
    positions over the whole context (full or KNN attention, MLA). The
    SSM's and the hybrid's prefill caches are not (F19), nor local
    attention's rolling buffer."""
    return cfg.family not in ("ssm", "hybrid", "audio") and cfg.attention != "local"


def prefill_into(params, cache, tokens: torch.Tensor, row: int, cfg: ModelConfig):
    """Prefill one prompt (1, S) into row ``row`` of a decode cache, in
    place: positions [0, S) of every layer's entries (keys and values, or
    MLA's latents and rotary keys); every other row and position is left
    bit for bit. Returns the prompt's logits (1, S, V). Needs S <= the
    cache's length and ``prefills_into_rows(cfg)``."""
    if not prefills_into_rows(cfg):
        raise ValueError(f"{cfg.name!r}: its prefill cache is not decode's "
                         "layout; prefill it token by token")
    logits, entries, _ = forward(params, tokens, cfg, return_cache=True)
    s = tokens.shape[1]
    names = ("c_kv", "k_pe") if cfg.mla else ("k", "v")
    for name, entry in zip(names, entries):
        cache[name][:, row, :s] = entry[:, 0]
    return logits


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, *,
            max_len: Optional[int] = None, positions=None):
    """Run the prompt, return (logits, cache ready for decode_step at
    pos = S). The SSM and hybrid caches are returned as ``forward`` gives
    them, as JAX's are: the SSM's final states are decode-ready; the
    hybrid's attention entries stay raw (k, v) tuples over the whole
    prompt, which ``decode_step`` cannot read (it raises ``TypeError``, as
    JAX's does)."""
    logits, caches, _ = forward(params, tokens, cfg, positions=positions,
                                return_cache=True)
    if cfg.family in ("ssm", "hybrid"):
        return logits, caches
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
