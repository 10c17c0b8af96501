"""Minimal param-spec module system (port of the spec half of
``repro/models/module.py``).

Models declare their parameters as a nested dict of ``ParamSpec`` leaves
(shape / initializer / scale / dtype); ``init_params`` materializes one
tree of tensors with the same structure, empty sub-dicts included (a
non-parametric norm's ``{}``). The sharding half of the JAX module (logical
axes, rules, ``constrain``) waits for the mesh port.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping, Optional

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    init: str = "fanin"  # normal | zeros | ones | embed | fanin
    scale: Optional[float] = None
    dtype: torch.dtype = torch.float32


def spec(shape, init="fanin", dtype=torch.float32, scale=None) -> ParamSpec:
    return ParamSpec(tuple(shape), init, scale, dtype)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def map_tree(fn: Callable[[tuple, Any], Any], tree: Mapping,
             path: tuple = ()) -> dict:
    """``fn(path, leaf)`` over a nested dict's leaves, keeping every
    sub-dict (empty ones too); ``path`` is the tuple of keys."""
    return {key: map_tree(fn, val, path + (key,)) if isinstance(val, Mapping)
            else fn(path + (key,), val) for key, val in tree.items()}


def leaves(tree: Mapping) -> dict[tuple, Any]:
    """{path: leaf} of a nested dict."""
    out: dict[tuple, Any] = {}
    map_tree(lambda path, leaf: out.__setitem__(path, leaf), tree)
    return out


def init_leaf(s: ParamSpec, generator: torch.Generator) -> torch.Tensor:
    """One leaf drawn as the JAX package's ``_init_leaf`` draws it (the
    same kinds and scales; other random numbers), on the generator's
    device."""
    shape, dev = s.shape, generator.device
    if s.init == "zeros":
        return torch.zeros(shape, dtype=s.dtype, device=dev)
    if s.init == "ones":
        return torch.ones(shape, dtype=s.dtype, device=dev)
    if s.init in ("normal", "embed"):
        default = 0.02 if s.init == "normal" else 1.0
        sd = s.scale if s.scale is not None else default
    elif s.init == "fanin":
        # contraction dim is the first axis by convention here
        fan_in = shape[0] if len(shape) >= 1 else 1
        sd = s.scale if s.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    else:
        raise ValueError(f"unknown init {s.init!r}")
    return (torch.randn(shape, generator=generator, device=dev) * sd).to(s.dtype)


def init_params(spec_tree: Mapping, *, generator: torch.Generator,
                device="cuda") -> dict:
    """Seeded parameters: each leaf drawn from ``generator`` (on its
    device) in the sorted order of the leaves' paths, then moved to
    ``device``. A CUDA generator draws on the card, a CPU one on the
    host."""
    dev = resolve_device(device)
    specs = leaves(spec_tree)
    drawn = {path: init_leaf(specs[path], generator) for path in sorted(specs)}
    return map_tree(lambda path, _: drawn[path].to(dev), spec_tree)
