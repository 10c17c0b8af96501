"""DigcSpec + GraphBuilder registry (port of ``repro/core/builder.py``).

* ``DigcSpec``     -- a frozen dataclass naming the implementation plus
  every knob the JAX package defines. Setting a knob the selected builder
  does not accept raises instead of being dropped.
* ``GraphBuilder`` -- one registered implementation: a batched build
  function, the knobs it accepts, capability flags and an optional fused
  aggregation kernel.
* the registry    -- ``register`` / ``get_builder`` / ``available_impls``
  / ``list_builders``. Builders register when their module is imported;
  ``_LAZY`` names that module, so ``get_builder("cuda")`` imports the
  kernel package on demand.
* the degradation ladder -- ``DEGRADATION_LADDER``, ``fallback_chain``,
  ``degraded_spec``: pure functions the serving engine's ``_degrade``
  walks.

Build functions are batched-first: x (B, N, D), y (B, M, D) or None (the
self-graph), pos_bias (B, N, M) or None -> (idx, dist), each (B, N, k).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class DigcSpec:
    """Complete specification of one DIGC invocation.

    ``impl``, ``k``, ``dilation`` and ``causal`` are common to every
    builder; the rest are strategy knobs that default to None (= builder
    default). ``k`` has no default: consumers that own a k (the ViG
    config) fill it in.
    """

    impl: str = "blocked"
    k: Optional[int] = None
    dilation: int = 1
    causal: bool = False
    # --- blocked / pallas tiling
    block_n: Optional[int] = None
    block_m: Optional[int] = None
    # --- streaming-engine merge strategy
    merge: Optional[str] = None
    fuse_norms: Optional[bool] = None
    group_w: Optional[int] = None
    # --- fused kernel variants
    interpret: Optional[bool] = None
    packed: Optional[bool] = None
    mxu_bf16: Optional[bool] = None
    bucket_rounds: Optional[int] = None
    kernel_merge: Optional[str] = None
    # --- cluster
    n_clusters: Optional[int] = None
    n_probe: Optional[int] = None
    capacity_factor: Optional[float] = None
    seed: Optional[int] = None
    # --- axial
    grid_h: Optional[int] = None
    grid_w: Optional[int] = None
    # --- stale-graph reuse
    reuse: Optional[str] = None
    drift_tau: Optional[float] = None
    max_stale: Optional[int] = None
    # --- ring (distributed)
    mesh: Optional[Any] = None
    axis_name: Optional[str] = None
    batch_axis: Optional[str] = None

    def mesh_shape(self) -> Optional[tuple[int, ...]]:
        """Rank counts of the spec's mesh axes (None when unsharded): part
        of the tuner's workload identity, since a schedule measured on an
        N-way ring is not a single-device schedule."""
        if self.mesh is None:
            return None
        return tuple(int(s) for s in self.mesh.shape.values())

    def replace(self, **kw) -> "DigcSpec":
        return dataclasses.replace(self, **kw)

    def with_grid(self, grid_h: int, grid_w: int) -> "DigcSpec":
        """Fill grid-geometry knobs if this spec's builder accepts them
        (a no-op for builders without grid knobs)."""
        builder = get_builder(self.impl)
        updates = {
            f: v
            for f, v in (("grid_h", grid_h), ("grid_w", grid_w))
            if f in builder.knobs
        }
        return self.replace(**updates) if updates else self

    def knobs(self) -> dict[str, Any]:
        """The non-None strategy-specific knobs of this spec."""
        return {
            f: getattr(self, f)
            for f in KNOB_FIELDS
            if getattr(self, f) is not None
        }


_COMMON_FIELDS = ("impl", "k", "dilation", "causal")
KNOB_FIELDS: tuple[str, ...] = tuple(
    f.name for f in dataclasses.fields(DigcSpec) if f.name not in _COMMON_FIELDS
)

# -- stale-graph reuse policy ----------------------------------------------

REUSE_POLICIES: tuple[str, ...] = ("off", "layer", "tick", "overlap")
# Stale-graph reuse knobs (accepted by stateful tiers).
REUSE_KNOBS: frozenset = frozenset({"reuse", "drift_tau", "max_stale"})
DEFAULT_DRIFT_TAU = 0.05
DEFAULT_MAX_STALE = 4


def reuse_params(spec: DigcSpec) -> tuple[Optional[str], float, int]:
    """The spec's effective (policy, drift_tau, max_stale) triple.

    Policy is None when reuse is off ("off" and unset both mean every call
    rebuilds). Unset knobs take the serving defaults; the values are
    checked by ``GraphBuilder.validate``.
    """
    policy = spec.reuse if spec.reuse not in (None, "off") else None
    tau = (float(spec.drift_tau) if spec.drift_tau is not None
           else DEFAULT_DRIFT_TAU)
    stale = (int(spec.max_stale) if spec.max_stale is not None
             else DEFAULT_MAX_STALE)
    return policy, tau, stale


@dataclasses.dataclass(frozen=True)
class GraphBuilder:
    """One registered graph-construction implementation.

    ``build(x, y, pos_bias, spec) -> (idx, dist)``; builders with
    ``supports_pad`` also take ``m_valid=`` ((M,) or (B, M) bool marking
    live co-nodes), builders with ``supports_state`` take
    ``state_entry=`` (a ``core.state.DigcStateEntry``) and then return
    ``(idx, dist, new_entry)``; for every other builder ``digc()`` passes
    the state through unchanged. Builders with ``supports_cache`` take
    ``cache=`` (a ``core.engine.DigcCache``) and ``cache_key=``, the
    legacy eager cache. ``exact`` is False for an approximate
    tier (``cluster``, ``axial``). ``distributed`` marks a builder that
    needs a mesh (``ring``). ``aggregate`` is an optional fused
    neighbour aggregation (x, y, idx) -> (B, N, D); None means
    ``mr_aggregate``.
    """

    name: str
    build: Callable
    knobs: frozenset
    supports_pos_bias: bool = False
    supports_causal: bool = False
    exact: bool = True
    supports_pad: bool = False
    supports_state: bool = False
    supports_cache: bool = False
    distributed: bool = False
    aggregate: Optional[Callable] = None
    doc: str = ""

    def validate(self, spec: DigcSpec, *, has_pos_bias: bool = False) -> None:
        """Reject knobs this builder does not accept (no silent drops)."""
        bad = [
            f
            for f in KNOB_FIELDS
            if getattr(spec, f) is not None and f not in self.knobs
        ]
        if bad:
            raise ValueError(
                f"DIGC impl {self.name!r} does not accept knob(s) {bad}; "
                f"accepted: {sorted(self.knobs) or '(none)'}"
            )
        if spec.causal and not self.supports_causal:
            raise ValueError(f"DIGC impl {self.name!r} does not support causal")
        if has_pos_bias and not self.supports_pos_bias:
            raise ValueError(f"DIGC impl {self.name!r} does not support pos_bias")
        # Reuse-policy values (the knob names were screened above): a
        # malformed policy fails at dispatch, not ticks later as a silent
        # always-rebuild.
        if spec.reuse is not None and spec.reuse not in REUSE_POLICIES:
            raise ValueError(
                f"DigcSpec.reuse={spec.reuse!r} is not a reuse policy; "
                f"valid: {REUSE_POLICIES}"
            )
        if spec.drift_tau is not None:
            if spec.drift_tau < 0:
                raise ValueError(
                    f"DigcSpec.drift_tau must be >= 0, got {spec.drift_tau}"
                )
            if spec.reuse in (None, "off"):
                raise ValueError(
                    "DigcSpec.drift_tau is set but reuse is off; pass "
                    "reuse='layer'|'tick'|'overlap' (a gate threshold "
                    "without a gate is a config error)"
                )
        if spec.max_stale is not None:
            if spec.max_stale < 1:
                raise ValueError(
                    f"DigcSpec.max_stale must be >= 1, got {spec.max_stale}"
                )
            if spec.reuse in (None, "off"):
                raise ValueError(
                    "DigcSpec.max_stale is set but reuse is off; pass "
                    "reuse='layer'|'tick'|'overlap'"
                )


_REGISTRY: dict[str, GraphBuilder] = {}

# name -> module whose import registers it.
_LAZY: dict[str, str] = {
    "reference": "repro_torch.core.digc",
    "blocked": "repro_torch.core.digc",
    "cuda": "repro_torch.kernels.ops",
    "cluster": "repro_torch.core.strategies",
    "axial": "repro_torch.core.strategies",
    "ring": "repro_torch.core.ring",
}


def register(builder: GraphBuilder, *, overwrite: bool = False) -> GraphBuilder:
    if builder.name in _REGISTRY and not overwrite:
        raise ValueError(f"GraphBuilder {builder.name!r} already registered")
    _REGISTRY[builder.name] = builder
    return builder


def available_impls() -> tuple[str, ...]:
    """Names of every registered (or lazily registrable) builder."""
    return tuple(sorted(set(_REGISTRY) | set(_LAZY)))


def get_builder(name: str) -> GraphBuilder:
    if name not in _REGISTRY and name in _LAZY:
        importlib.import_module(_LAZY[name])
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown DIGC impl: {name!r}; available: {available_impls()}"
        )
    return _REGISTRY[name]


def list_builders() -> tuple[GraphBuilder, ...]:
    """All builders, importing their defining modules."""
    return tuple(get_builder(n) for n in available_impls())


# The degradation ladder: when a tier cannot serve, the same request goes
# to the next, less specialized one. Each rung accepts the common spec
# fields with no tier knobs, needs less machinery than the rung above
# (cuda needs nvcc and a card; blocked only torch; reference only a full
# distance matrix) and is never less exact.
DEGRADATION_LADDER: tuple[str, ...] = ("cuda", "blocked", "reference")


def fallback_chain(impl: str) -> tuple[str, ...]:
    """Ordered impls to serve through when ``impl`` is unhealthy; empty
    for the last rung (reference). Tiers off the ladder degrade into its
    exact single-device chain."""
    if impl in DEGRADATION_LADDER:
        return DEGRADATION_LADDER[DEGRADATION_LADDER.index(impl) + 1:]
    return DEGRADATION_LADDER[1:]


def degraded_spec(spec: DigcSpec, impl: str) -> DigcSpec:
    """``spec``'s common fields on a degraded impl: the failed tier's
    knobs (and the reuse knobs) are dropped."""
    return DigcSpec(impl=impl, k=spec.k, dilation=spec.dilation,
                    causal=spec.causal)


def resolve_spec(
    spec: Optional[DigcSpec] = None,
    *,
    impl: Optional[str] = None,
    k: Optional[int] = None,
    dilation: Optional[int] = None,
    causal: Optional[bool] = None,
    **knobs,
) -> DigcSpec:
    """Build (or refine) a DigcSpec from keyword-style arguments; any
    explicitly passed field overrides the spec's. Unknown knob names
    raise immediately."""
    unknown = set(knobs) - set(KNOB_FIELDS)
    if unknown:
        raise ValueError(
            f"unknown DIGC knob(s) {sorted(unknown)}; valid knobs: "
            f"{list(KNOB_FIELDS)}"
        )
    if spec is None:
        if k is None:
            raise TypeError("digc() requires k= (or a full spec=)")
        return DigcSpec(
            impl=impl or "blocked",
            k=k,
            dilation=1 if dilation is None else dilation,
            causal=bool(causal),
            **knobs,
        )
    overrides: dict[str, Any] = dict(knobs)
    if impl is not None:
        overrides["impl"] = impl
    if k is not None:
        overrides["k"] = k
    if dilation is not None:
        overrides["dilation"] = dilation
    if causal is not None:
        overrides["causal"] = causal
    spec = spec.replace(**overrides) if overrides else spec
    if spec.k is None:
        raise TypeError("DigcSpec.k is unset: pass k= or spec.replace(k=...)")
    return spec


def promote_batch(x: torch.Tensor, y: Optional[torch.Tensor] = None,
                  pos_bias: Optional[torch.Tensor] = None):
    """Lift (N, D) [+ (N, M) pos_bias] to B=1; pass (B, N, D) through.

    Returns (x3, y3, pos3, squeeze) where squeeze records whether the
    caller should drop the batch axis from the outputs.
    """
    if x.ndim not in (2, 3):
        raise ValueError(f"DIGC nodes must be (N, D) or (B, N, D); got "
                         f"{tuple(x.shape)}")
    squeeze = x.ndim == 2
    x3 = x[None] if squeeze else x
    if y is None:
        y3 = x3
    else:
        if y.ndim not in (2, 3):
            raise ValueError(
                f"DIGC co-nodes must be (M, D) or (B, M, D); got "
                f"{tuple(y.shape)}"
            )
        y3 = y[None] if y.ndim == 2 else y
    if y3.shape[0] != x3.shape[0]:
        raise ValueError(
            f"batch mismatch: nodes {x3.shape[0]} vs co-nodes {y3.shape[0]}"
        )
    p3 = None
    if pos_bias is not None:
        if pos_bias.ndim not in (2, 3):
            raise ValueError(
                f"pos_bias must be (N, M) or (B, N, M); got "
                f"{tuple(pos_bias.shape)}"
            )
        p3 = pos_bias[None] if pos_bias.ndim == 2 else pos_bias
        n, m = x3.shape[1], y3.shape[1]
        if tuple(p3.shape[1:]) != (n, m):
            raise ValueError(
                f"pos_bias shape {tuple(pos_bias.shape)} does not match "
                f"N={n} nodes x M={m} co-nodes"
            )
        if p3.shape[0] not in (1, x3.shape[0]):
            raise ValueError(
                f"pos_bias batch {p3.shape[0]} does not match nodes batch "
                f"{x3.shape[0]} (or 1 for shared)"
            )
        if p3.shape[0] != x3.shape[0]:
            p3 = p3.expand((x3.shape[0],) + tuple(p3.shape[1:]))
    return x3, y3, p3, squeeze
