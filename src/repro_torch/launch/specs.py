"""Dry-run cells: abstract arguments and their shardings for every (arch x
input shape) cell (port of ``repro/launch/specs.py``).

Arguments are ``meta`` tensors (shapes and dtypes, no storage: the
counterpart of JAX's ``ShapeDtypeStruct``) and each has a
``models.module.Sharding`` leaf, the counterpart of ``NamedSharding``,
with JAX's spec entries after ``_drop_indivisible``. Meshes are
descriptions (``launch.mesh.abstract_mesh``): nothing here starts a
process group or allocates a byte.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.api import get_api
from repro_torch.models.config import ModelConfig
from repro_torch.models.module import (
    DEFAULT_RULES,
    Sharding,
    _drop_indivisible,
    abstract_params,
    make_shardings,
    rules_for,
)
from repro_torch.train.optimizer import OptConfig, OptState
from repro_torch.train.trainer import make_train_step

META = torch.device("meta")


def _abs(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _batch_axes(mesh):
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _shard(mesh, shape, spec_entries) -> Sharding:
    return Sharding(mesh, _drop_indivisible(shape, tuple(spec_entries), mesh))


def _as_tuple(v):
    return (v,) if isinstance(v, str) else tuple(v)


def _tree_map(fn, tree):
    """``fn`` over the tensor leaves of nested dicts, tuples and lists."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return type(tree)(_tree_map(fn, v) for v in tree)


def shard_batch_tree(tree, mesh, rules=DEFAULT_RULES):
    """Batch inputs: dim0 = batch per the active rules (default
    (pod, data); batch-over-model policies add the model axis)."""
    bd = tuple(a for a in _as_tuple(rules.get("batch", ("pod", "data")))
               if a in mesh.axis_names)

    def one(x):
        return _shard(mesh, x.shape, [bd] + [None] * (x.ndim - 1))

    return _tree_map(one, tree)


def shard_cache_tree(tree, mesh):
    """Decode caches: stacked (L, B, T, ...) leaves. Batch over
    (pod, data); for KV-like leaves shard heads over model when they
    divide, else the sequence dim (sequence-parallel decode)."""
    bd = _batch_axes(mesh)
    model = "model" if "model" in mesh.axis_names else None
    msize = mesh.shape[model] if model else 1

    def one(x):
        entries: list[Any] = [None] * x.ndim
        if x.ndim >= 2:
            entries[1] = bd  # batch after the layers dim
        if model and x.ndim >= 3:
            # kv heads (ndim - 2) first, then the sequence dim (2); the
            # head dim (the attention contraction) never.
            candidates = [x.ndim - 2] if x.ndim >= 4 else []
            candidates.append(2)
            for d in candidates:
                if d < x.ndim and x.shape[d] % msize == 0 and x.shape[d] >= msize:
                    entries[d] = model
                    break
        return _shard(mesh, x.shape, entries)

    return _tree_map(one, tree)


def make_cell(arch: str, shape_id: str, mesh, *,
              cfg: Optional[ModelConfig] = None, rules=DEFAULT_RULES) -> dict:
    """(step fn, abstract args, in_shardings) of one dry-run cell: a dict
    with keys fn, args (a tuple of ``meta`` trees), in_shardings (the
    same structure of ``Sharding`` leaves), kind, cfg, rules."""
    seq_len, global_batch, kind = SHAPES[shape_id]
    return step_cell(cfg or get_config(arch), kind, seq_len, global_batch,
                     mesh, rules=rules)


def step_cell(cfg: ModelConfig, kind: str, seq_len: int, global_batch: int,
              mesh, *, rules=DEFAULT_RULES) -> dict:
    """``make_cell`` at any (kind, sequence, batch): a ``train`` step on
    (batch, seq) tokens, a ``prefill`` of them, or one ``decode`` token
    against a cache of ``seq_len``."""
    if rules is DEFAULT_RULES:
        rules = rules_for(cfg)
    api = get_api(cfg)
    spec_tree = api.param_spec()
    params_abs = _tree_map(
        lambda t: t.to(cfg.compute_dtype) if t.is_floating_point() else t,
        abstract_params(spec_tree))
    params_sh = make_shardings(spec_tree, mesh, rules)
    out = {"kind": kind, "cfg": cfg, "rules": rules}

    if kind == "train":
        batch = _train_batch_abs(cfg, seq_len, global_batch)
        f32 = lambda tree: _tree_map(lambda t: _abs(t.shape, torch.float32), tree)  # noqa: E731
        opt_abs = OptState(step=_abs((), torch.int32), mu=f32(params_abs),
                           nu=f32(params_abs), master=f32(params_abs))
        opt_sh = OptState(step=Sharding(mesh, ()), mu=params_sh, nu=params_sh,
                          master=params_sh)
        return {**out, "fn": make_train_step(cfg, OptConfig(), loss_fn=api.loss_fn),
                "args": (params_abs, opt_abs, batch),
                "in_shardings": (params_sh, opt_sh,
                                 shard_batch_tree(batch, mesh, rules))}

    if kind == "prefill":
        batch = _prefill_batch_abs(cfg, seq_len, global_batch)
        return {**out, "fn": lambda params, batch: api.prefill_fn(params, batch),
                "args": (params_abs, batch),
                "in_shardings": (params_sh, shard_batch_tree(batch, mesh, rules))}

    # decode: one new token against a cache of length seq_len
    cache_abs = api.init_cache(global_batch, seq_len, device=META)
    tokens = _abs((global_batch, 1), torch.int32)
    args = [params_abs, cache_abs, tokens, _abs((), torch.int32)]
    shardings = [params_sh, shard_cache_tree(cache_abs, mesh),
                 shard_batch_tree(tokens, mesh, rules), Sharding(mesh, ())]
    fn = api.decode_fn
    if cfg.mrope_sections:
        positions = _abs((3, global_batch, 1), torch.int32)
        args.append(positions)
        shardings.append(_shard(mesh, positions.shape,
                                [None, _batch_axes(mesh), None]))
        fn = lambda p, c, t, pos, positions: api.decode_fn(  # noqa: E731
            p, c, t, pos, positions=positions)
    return {**out, "fn": fn, "args": tuple(args),
            "in_shardings": tuple(shardings)}


def _train_batch_abs(cfg: ModelConfig, seq_len: int, global_batch: int) -> dict:
    b, s = global_batch, seq_len
    batch = {"tokens": _abs((b, s), torch.int32),
             "labels": _abs((b, s), torch.int32),
             "mask": _abs((b, s), torch.float32)}
    if cfg.family == "audio":
        batch["frames"] = _abs((b, s, cfg.d_model), cfg.compute_dtype)
    if cfg.mrope_sections:
        batch["positions"] = _abs((3, b, s), torch.int32)
    return batch


def _prefill_batch_abs(cfg: ModelConfig, seq_len: int, global_batch: int) -> dict:
    b, s = global_batch, seq_len
    batch = {"tokens": _abs((b, s), torch.int32)}
    if cfg.family == "audio":
        batch["frames"] = _abs((b, s, cfg.d_model), cfg.compute_dtype)
    if cfg.mrope_sections:
        batch["positions"] = _abs((3, b, s), torch.int32)
    return batch
