"""Minimal param-spec module system (port of ``repro/models/module.py``).

Models declare their parameters as a nested dict of ``ParamSpec`` leaves
(shape / initializer / scale / dtype / logical axes); ``init_params``
materializes one tree of tensors with the same structure, empty
sub-dicts included (a non-parametric norm's ``{}``).

``abstract_params`` gives the same tree as ``meta`` tensors (shapes and
dtypes, no storage): the dry-run traces full-size steps on them.

The sharding half maps logical axis names to mesh axes by a rules dict
(MaxText-style, JAX's ``DEFAULT_RULES``): ``make_shardings`` gives each
leaf a ``Sharding(mesh, spec)`` record whose ``spec`` is a tuple with the
entries of JAX's ``PartitionSpec`` (``ckpt.checkpoint.restore`` places a
leaf by it). ``constrain`` is the identity: eager values are global on
every rank and no GSPMD pass exists to take a hint.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping, NamedTuple, Optional, Sequence

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    init: str = "fanin"  # normal | zeros | ones | embed | fanin
    scale: Optional[float] = None
    dtype: torch.dtype = torch.float32
    axes: Optional[tuple[Optional[str], ...]] = None  # logical, len == ndim

    def __post_init__(self):
        assert self.axes is None or len(self.axes) == len(self.shape), (
            self.shape, self.axes)


def spec(shape, axes=None, init="fanin", dtype=torch.float32,
         scale=None) -> ParamSpec:
    return ParamSpec(tuple(shape), init, scale, dtype,
                     None if axes is None else tuple(axes))


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


def abstract_params(spec_tree: Mapping) -> dict:
    """Each ``ParamSpec`` as a ``meta`` tensor of its shape and dtype (the
    counterpart of JAX's ``ShapeDtypeStruct`` tree)."""
    return map_tree(lambda _, s: torch.empty(s.shape, dtype=s.dtype,
                                             device="meta"), spec_tree)


# ---------------------------------------------------------------------------
# Sharding rules

# Default logical-axis -> mesh-axis mapping. "model" carries tensor/expert
# parallelism; "data" carries FSDP (ZeRO-3) sharding of the d_model /
# embed dimension of parameters; batch is sharded over (pod, data).
DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    # attention fallback when heads % TP != 0: batch takes the model
    # axis too (data+model first so single-pod meshes fully shard)
    "attn_batch": ("data", "model", "pod"),
    "embed": "data",  # FSDP axis for params
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": "model",
    "expert_mlp": None,
    "kv_lora": None,
    "head_dim": None,
    "state": None,
    "conv": None,
    "seq": None,
    "act_seq": None,
    "act_embed": None,
    "act_heads": "model",
    "act_vocab": "model",
    "act_kv": None,
    "act_cache": "model",  # decode logits' cache-seq dim (flash-decode)
    "stage": "stage",
    "layers": None,
}


class Sharding(NamedTuple):
    """A leaf's placement: the mesh and a spec with one entry per
    dimension (None, a mesh axis name, or a tuple of them), as JAX's
    ``NamedSharding(mesh, PartitionSpec(*spec))``."""

    mesh: Any
    spec: tuple

    def shard_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        """One device's block of an array of ``shape`` (JAX's
        ``NamedSharding.shard_shape``); raises where the mesh axes of a
        dimension do not divide it."""
        entries = tuple(self.spec) + (None,) * (len(shape) - len(self.spec))
        out = []
        for dim, entry in zip(shape, entries):
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else tuple(entry))
            ways = math.prod(self.mesh.shape[a] for a in axes)
            if dim % ways:
                raise ValueError(
                    f"dimension {dim} of {tuple(shape)} is not divisible by "
                    f"the {ways} devices of mesh axes {axes}")
            out.append(dim // ways)
        return tuple(out)


def rules_for(cfg) -> dict:
    """Sharding rules adjusted for the config's parallelism policy."""
    if getattr(cfg, "shard_batch_over_model", False):
        r = dict(DEFAULT_RULES)
        r["batch"] = ("data", "model", "pod")
        r["act_heads"] = None  # heads replicated; batch covers model
        r["act_kv"] = None
        r["act_vocab"] = None  # logits batch-sharded instead
        r["act_cache"] = None
        return r
    return DEFAULT_RULES


def mesh_axes_for(axes: Sequence[Optional[str]], rules: Mapping[str, Any],
                  mesh) -> tuple:
    """Translate logical axes to a spec valid for ``mesh``."""
    names = set(mesh.axis_names)
    out = []
    for ax in axes:
        target = rules.get(ax) if ax is not None else None
        if target is None:
            out.append(None)
            continue
        if isinstance(target, str):
            out.append(target if target in names else None)
        else:  # tuple of axes; keep the ones present in this mesh
            kept = tuple(t for t in target if t in names)
            out.append(kept if kept else None)
    return tuple(out)


def _drop_indivisible(shape, ps: tuple, mesh) -> tuple:
    """Drop mesh axes that don't divide the dim (e.g. kv_heads=1 can't
    shard 16 ways)."""
    out = []
    for dim, entry in zip(shape, tuple(ps) + (None,) * (len(shape) - len(ps))):
        if entry is None:
            out.append(None)
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        total = 1
        kept = []
        for a in axes:
            size = mesh.shape[a]
            if dim % (total * size) == 0:
                kept.append(a)
                total *= size
        out.append(tuple(kept) if len(kept) > 1 else (kept[0] if kept else None))
    return tuple(out)


def make_shardings(spec_tree: Mapping, mesh,
                   rules: Mapping[str, Any] = DEFAULT_RULES) -> dict:
    """A ``Sharding`` per leaf of ``spec_tree`` (same structure)."""
    def one(_, s: ParamSpec):
        if s.axes is None:
            raise ValueError(f"ParamSpec {s.shape} declares no logical axes")
        ps = mesh_axes_for(s.axes, rules, mesh)
        return Sharding(mesh, _drop_indivisible(s.shape, ps, mesh))

    return map_tree(one, spec_tree)


# Explicit (mesh, rules) context, as JAX's: ``constrain`` and
# ``moe_apply`` read it.
_ACTIVE_MESH: list[tuple[Any, Mapping[str, Any]]] = []


class use_mesh:
    """Context manager making ``mesh`` (+ sharding rules) the active one."""

    def __init__(self, mesh, rules: Optional[Mapping[str, Any]] = None):
        self.mesh = mesh
        self.rules = rules if rules is not None else DEFAULT_RULES

    def __enter__(self):
        _ACTIVE_MESH.append((self.mesh, self.rules))
        return self.mesh

    def __exit__(self, *exc):
        _ACTIVE_MESH.pop()
        return False


def active_mesh():
    return _ACTIVE_MESH[-1][0] if _ACTIVE_MESH else None


def active_rules() -> Mapping[str, Any]:
    return _ACTIVE_MESH[-1][1] if _ACTIVE_MESH else DEFAULT_RULES


def constrain(x: torch.Tensor, axes: Sequence[Optional[str]],
              rules: Optional[Mapping[str, Any]] = None) -> torch.Tensor:
    """Activation sharding hint by logical axes: the identity. JAX hands
    the hint to GSPMD; the port's eager values are global on every rank,
    and no pass exists to take it."""
    del axes, rules
    return x
