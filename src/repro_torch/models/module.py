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


# Elements drawn at a time into a leaf held in a narrower dtype than its
# draw (fp32): 256 MB of fp32 working memory.
_DRAW_ELEMS = 1 << 26


def _leaf_sd(s: ParamSpec) -> float:
    if s.init in ("normal", "embed"):
        default = 0.02 if s.init == "normal" else 1.0
        return s.scale if s.scale is not None else default
    if s.init == "fanin":
        # contraction dim is the first axis by convention here
        fan_in = s.shape[0] if len(s.shape) >= 1 else 1
        return s.scale if s.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    raise ValueError(f"unknown init {s.init!r}")


def init_leaf(s: ParamSpec, generator: torch.Generator,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One leaf drawn as the JAX package's ``_init_leaf`` draws it (the
    same kinds and scales; other random numbers), on the generator's
    device, held in ``dtype`` (None: the spec's). A leaf held in the
    spec's dtype is drawn whole; one held narrower is drawn in fp32 a
    slice of its leading axis (``_DRAW_ELEMS`` elements) at a time and
    each slice cast into it, so no fp32 copy of the whole leaf exists."""
    shape, dev = s.shape, generator.device
    dtype = dtype or s.dtype
    if s.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=dev)
    if s.init == "ones":
        return torch.ones(shape, dtype=dtype, device=dev)
    sd = _leaf_sd(s)
    if dtype == s.dtype:
        return (torch.randn(shape, generator=generator, device=dev) * sd).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=dev)
    step = max(1, _DRAW_ELEMS // max(1, math.prod(shape[1:])))
    for start in range(0, shape[0], step):
        part = out[start:start + step]
        part.copy_(torch.randn(part.shape, generator=generator,
                               device=dev).mul_(sd))
    return out


def init_params(spec_tree: Mapping, *, generator: torch.Generator,
                device="cuda",
                dtype_of: Optional[Callable[[tuple], torch.dtype]] = None) -> dict:
    """Seeded parameters: each leaf drawn from ``generator`` (on its
    device) in the sorted order of the leaves' paths, then moved to
    ``device``. A CUDA generator draws on the card, a CPU one on the
    host. ``dtype_of(path)`` is the dtype each leaf is held in (None: the
    spec's, fp32): a serving tree drawn straight into its compute dtypes
    (``transformer.compute_dtype``) never holds an fp32 copy."""
    dev = resolve_device(device)
    specs = leaves(spec_tree)
    drawn = {path: init_leaf(specs[path], generator,
                             None if dtype_of is None else dtype_of(path))
             for path in sorted(specs)}
    return map_tree(lambda path, _: drawn[path].to(dev), spec_tree)
