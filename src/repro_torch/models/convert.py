"""Parameters: the ViG spec, a seeded init, and conversion from the JAX
package's parameter trees (ViG and the decoder LM); and the DIGC state's
conversion to and from nested numpy arrays, the form a JAX ``DigcState``
takes on the host.

Parameters are a nested dict of tensors with the JAX tree's structure and
names (``params["stage0"]["block0"]["fc_in"]``,
``params["layers"]["mix"]["wq"]``). Every dense weight is stored (in,
out), as in JAX, and applied as ``x @ W``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core.state import FIELDS, DigcState, DigcStateEntry
from repro_torch.device import resolve_device
from repro_torch.models import encdec, module, transformer
from repro_torch.models.module import ParamSpec


def _block_spec(d: int, ffn: int) -> dict:
    return {
        "ln_g": {"scale": ParamSpec((d,), "ones")},
        "fc_in": ParamSpec((d, d)),
        "fc_graph": ParamSpec((2 * d, d)),
        "fc_out": ParamSpec((d, d)),
        "ln_f": {"scale": ParamSpec((d,), "ones")},
        "fc1": ParamSpec((d, ffn * d)),
        "fc2": ParamSpec((ffn * d, d)),
    }


def vig_param_spec(cfg) -> dict:
    """The parameter tree of a ``VigConfig`` (``repro/models/vig.py``'s
    ``vig_param_spec``), as ParamSpec leaves."""
    n0 = cfg.base_grid * cfg.base_grid
    p: dict[str, Any] = {
        "stem": ParamSpec((cfg.patch * cfg.patch * cfg.in_chans,
                           cfg.embed_dims[0])),
        "pos": ParamSpec((n0, cfg.embed_dims[0]), "normal"),
        "head": ParamSpec((cfg.embed_dims[-1], cfg.num_classes)),
    }
    for si, (d, depth) in enumerate(zip(cfg.embed_dims, cfg.depths)):
        p[f"stage{si}"] = {
            f"block{bi}": _block_spec(d, cfg.ffn_ratio) for bi in range(depth)
        }
        if si + 1 < len(cfg.embed_dims):
            p[f"down{si}"] = ParamSpec((4 * d, cfg.embed_dims[si + 1]))
    return p


def flatten(tree: Mapping, prefix: str = "") -> dict[str, Any]:
    """Nested dict -> {"stage0/block0/fc_in": leaf, ...}."""
    out = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(flatten(val, path + "/"))
        else:
            out[path] = val
    return out


def unflatten(flat: Mapping[str, Any]) -> dict:
    """{"a/b": leaf} -> {"a": {"b": leaf}}."""
    tree: dict = {}
    for path, val in flat.items():
        node = tree
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = val
    return tree


def init_params(cfg, *, generator: torch.Generator, device="cuda") -> dict:
    """Seeded random parameters (``module.init_params`` over the spec).
    Different numbers from JAX's init for the same seed: tests share
    weights through ``params_from_numpy``."""
    return module.init_params(vig_param_spec(cfg), generator=generator,
                              device=device)


def params_from_numpy(cfg, tree: Mapping, *, device="cuda") -> dict:
    """The JAX parameter tree as numpy arrays (``jax.tree.map(np.asarray,
    params)``) -> the port's parameters (fp32 tensors on ``device``).
    Raises unless the tree has exactly the spec's paths and shapes."""
    dev = resolve_device(device)
    want = flatten(vig_param_spec(cfg))
    got = flatten(tree)
    if set(got) != set(want):
        raise ValueError(
            f"parameter tree does not match {cfg.name!r}: missing "
            f"{sorted(set(want) - set(got))}, unexpected "
            f"{sorted(set(got) - set(want))}"
        )
    out = {}
    for path, s in want.items():
        arr = np.asarray(got[path], dtype=np.float32)
        if arr.shape != s.shape:
            raise ValueError(f"{path}: shape {arr.shape}, expected {s.shape}")
        out[path] = torch.from_numpy(arr.copy()).to(dev)
    return unflatten(out)


def params_to_numpy(params: Mapping) -> dict:
    """The port's parameters -> a nested dict of numpy arrays (the JAX
    tree's layout)."""
    return unflatten({
        path: t.detach().cpu().numpy() for path, t in flatten(params).items()
    })


def lm_param_spec(cfg) -> dict:
    """The LM family's parameter spec: ``encdec.encdec_param_spec`` for
    the encoder-decoder (family ``audio``), else
    ``transformer.param_spec``."""
    if cfg.family == "audio":
        return encdec.encdec_param_spec(cfg)
    return transformer.param_spec(cfg)


def lm_params_from_numpy(cfg, tree: Mapping, *, device="cuda") -> dict:
    """A JAX LM parameter tree as numpy arrays (``jax.tree.map(np.asarray,
    init_params(api.param_spec(), key))``) -> the port's tree (fp32
    tensors on ``device``, empty sub-dicts kept). Raises unless the tree
    has exactly ``lm_param_spec(cfg)``'s paths and shapes."""
    dev = resolve_device(device)
    want = module.leaves(lm_param_spec(cfg))
    got = module.leaves(tree)
    if set(got) != set(want):
        raise ValueError(
            f"parameter tree does not match {cfg.name!r}: missing "
            f"{sorted('/'.join(p) for p in set(want) - set(got))}, unexpected "
            f"{sorted('/'.join(p) for p in set(got) - set(want))}"
        )

    def one(path, s):
        arr = np.asarray(got[path], dtype=np.float32)
        if arr.shape != s.shape:
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape}, "
                             f"expected {s.shape}")
        return torch.from_numpy(arr.copy()).to(dev)

    return module.map_tree(one, lm_param_spec(cfg))


def lm_params_to_numpy(params: Mapping) -> dict:
    """The port's LM parameters -> the JAX tree's layout as numpy arrays
    (fp32)."""
    return module.map_tree(lambda _, t: t.detach().float().cpu().numpy(), params)


def state_from_numpy(tree: Mapping, *, device="cuda") -> DigcState:
    """``{key: {field: array or None}}`` (a JAX ``DigcState`` as nested
    numpy arrays: ``{k: {f: np.asarray(getattr(e, f))}}`` over its
    entries, None where a field is None) -> the port's ``DigcState`` on
    ``device``. Fields are those of ``DigcStateEntry``; a missing field
    is None, an unknown one raises."""
    dev = resolve_device(device)
    entries = {}
    for key, fields in tree.items():
        unknown = set(fields) - set(FIELDS)
        if unknown or "step" not in fields:
            raise ValueError(
                f"state entry {key!r}: fields {sorted(fields)} are not "
                f"those of DigcStateEntry {FIELDS} (step required)")
        entries[key] = DigcStateEntry(**{
            f: None if fields.get(f) is None
            else torch.from_numpy(np.array(fields[f])).to(dev)
            for f in FIELDS
        })
    return DigcState.init(entries)


def state_to_numpy(state: DigcState) -> dict:
    """The port's ``DigcState`` -> ``{key: {field: np.ndarray or None}}``."""
    return {
        key: {f: None if getattr(e, f) is None
              else getattr(e, f).detach().cpu().numpy() for f in FIELDS}
        for key, e in state.entries.items()
    }
