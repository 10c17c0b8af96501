"""Vision GNN (ViG) backbones, isotropic and pyramid (port of
``repro/models/vig.py``).

Each Grapher block re-runs DIGC on the current features and aggregates
neighbours with max-relative graph convolution. The DIGC implementation
is a constructor choice resolved through the GraphBuilder registry
(``digc_impl`` names a registered builder, or pass a DigcSpec); each
builder brings its own fused aggregation if it has one. Pyramid stages
pool co-nodes by the stage reduction ratio r before graph construction
(M = N / r^2).

Layouts are the JAX package's: NHWC images, (B, N, D) features, dense
weights (in, out). Construction state crosses blocks and requests as a
functional ``core.state.DigcState`` (``init_vig_state``; ``vig_forward(...,
state=)`` returns ``(logits, new_state)``): blocks of a stage share one
entry, so block l + 1 warm-starts from block l (or, under a ``reuse``
policy, serves its graph). The forward serves any square grid that
``vig_stage_plans`` accepts (the positional embedding is resampled as
``jax.image.resize`` does, ``_pos_for_grid``), and ``valid_mask`` keeps
zero-padded pad nodes out of every top-k and the mean pooling.
``vig_loss_fn`` is the training loss. Not ported: the eager cache.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.builder import DigcSpec, get_builder, reuse_params
from repro_torch.core.digc import RefreshFork, digc
from repro_torch.core.engine import live_mask
from repro_torch.core.graph import mr_aggregate
from repro_torch.core.state import DigcState, state_entry
from repro_torch.core.strategies import default_cluster_params
from repro_torch.core.tuner import VigSchedule
from repro_torch.models.transformer import softmax_xent
from repro_torch.device import resolve_device
from repro_torch.models.convert import flatten, init_params, unflatten, vig_param_spec  # noqa: F401


class VigGridError(ValueError):
    """Typed config-time error for grid geometry a model cannot run:
    non-square / non-patch-aligned inputs, or a pyramid stage whose grid
    is not divisible by its reduce ratio or by the 2x downsample."""


@dataclasses.dataclass(frozen=True)
class VigConfig:
    name: str
    variant: str  # isotropic | pyramid
    image_size: int = 224
    patch: int = 16
    in_chans: int = 3
    embed_dims: tuple[int, ...] = (192,)
    depths: tuple[int, ...] = (12,)
    reduce_ratios: tuple[int, ...] = (1,)
    k: int = 9
    max_dilation: int = 4
    use_dilation: bool = True
    num_classes: int = 1000
    digc_impl: str = "blocked"
    ffn_ratio: int = 4

    @property
    def base_grid(self) -> int:
        return self.image_size // self.patch

    def grid_at_stage(self, si: int) -> int:
        return max(self.base_grid // (2**si), 1)

    def replace(self, **kw) -> "VigConfig":
        return dataclasses.replace(self, **kw)


# ViG paper variants.
VIG_VARIANTS = {
    "vig_ti_iso": VigConfig("vig_ti_iso", "isotropic", embed_dims=(192,), depths=(12,)),
    "vig_s_iso": VigConfig("vig_s_iso", "isotropic", embed_dims=(320,), depths=(16,)),
    "vig_b_iso": VigConfig("vig_b_iso", "isotropic", embed_dims=(640,), depths=(16,)),
    "vig_ti_pyr": VigConfig(
        "vig_ti_pyr", "pyramid", patch=4, embed_dims=(48, 96, 240, 384),
        depths=(2, 2, 6, 2), reduce_ratios=(4, 2, 1, 1),
    ),
    "vig_s_pyr": VigConfig(
        "vig_s_pyr", "pyramid", patch=4, embed_dims=(80, 160, 400, 640),
        depths=(2, 2, 6, 2), reduce_ratios=(4, 2, 1, 1),
    ),
    "vig_m_pyr": VigConfig(
        "vig_m_pyr", "pyramid", patch=4, embed_dims=(96, 192, 384, 768),
        depths=(2, 2, 16, 2), reduce_ratios=(4, 2, 1, 1),
    ),
    "vig_b_pyr": VigConfig(
        "vig_b_pyr", "pyramid", patch=4, embed_dims=(128, 256, 512, 1024),
        depths=(2, 2, 18, 2), reduce_ratios=(4, 2, 1, 1),
    ),
}


# ---------------------------------------------------------------------------
# Forward pieces


def _ln(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """LayerNorm with a scale and no bias: population variance, eps 1e-6,
    computed in fp32 (not ``nn.LayerNorm``'s defaults)."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + 1e-6) * scale).to(x.dtype)


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, N, patch*patch*C)."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, gh, patch, gw, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


def _pool_conodes(x: torch.Tensor, grid: int, r: int) -> Optional[torch.Tensor]:
    """(B, N, D) on a grid -> average-pooled co-nodes (B, N/r^2, D); None
    for r <= 1 (co-nodes are the nodes: the registry's self-graph)."""
    if r <= 1:
        return None
    if grid % r:
        raise VigGridError(
            f"co-node pooling needs grid divisible by r={r}; got "
            f"grid={grid} (vig_stage_plans screens this at config time)"
        )
    b, n, d = x.shape
    g2 = grid // r
    xg = x.reshape(b, g2, r, g2, r, d)
    return xg.mean(dim=(2, 4)).reshape(b, g2 * g2, d)


def _downsample(x: torch.Tensor, grid: int, w: torch.Tensor) -> torch.Tensor:
    """2x2 patch-merge + linear projection; channels ordered
    (row offset, column offset, feature) as in the JAX package."""
    if grid % 2:
        raise VigGridError(
            f"2x2 downsample needs an even grid; got grid={grid} "
            f"(vig_stage_plans screens this at config time)"
        )
    b, n, d = x.shape
    g2 = grid // 2
    xg = x.reshape(b, g2, 2, g2, 2, d).permute(0, 1, 3, 2, 4, 5)
    xg = xg.reshape(b, g2 * g2, 4 * d)
    return xg @ w


def _dilation_for(cfg: VigConfig, global_block: int, m: int,
                  k: Optional[int] = None, *,
                  grid: Optional[int] = None,
                  base_grid: Optional[int] = None) -> int:
    if not cfg.use_dilation:
        return 1
    k = cfg.k if k is None else k
    d = global_block // 4 + 1
    cap = cfg.max_dilation
    if grid is not None and base_grid is not None:
        d = _resolution_dilation(d, grid, base_grid)
        cap = _resolution_dilation(cap, grid, base_grid)
    d = min(d, cap)
    while k * d > m and d > 1:
        d -= 1
    return d


def _resolution_k(k: int, grid: int, base_grid: int) -> int:
    """k at the native grid, ramping linearly to 2k at twice the native
    grid, clamped to [k, 2k]; grids at or below native keep k."""
    if grid <= base_grid:
        return k
    frac = min(1.0, (grid - base_grid) / base_grid)
    return int(round(k * (1.0 + frac)))


def _resolution_dilation(d: int, grid: int, base_grid: int) -> int:
    """The dilation stride on the same ramp as ``_resolution_k``."""
    if grid <= base_grid:
        return d
    frac = min(1.0, (grid - base_grid) / base_grid)
    return int(round(d * (1.0 + frac)))


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_out, n_in) weights of ``jax.image.resize(method="bilinear")``
    along one axis (``compute_weight_mat`` of JAX's
    ``scale_and_translate``): a triangle kernel on half-pixel centres,
    widened by 1 / scale when shrinking (the antialias), each output's
    weights normalised to sum 1, in fp32. The inverse scale is
    ``n_in / n_out`` rounded once to fp32, as the compiled JAX resize
    folds it (``1 / fp32(n_out / n_in)`` moves the samples by an ulp,
    which shows as ~3e-5 at 56 -> 64). Built on ``device`` with no host
    copy, so a CUDA graph can capture it."""
    inv = float(np.float32(n_in / n_out))
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv - 0.5
    cols = torch.arange(n_in, dtype=torch.float32, device=device)
    w = (1.0 - (sample[:, None] - cols[None, :]).abs() / max(inv, 1.0)).clamp_min(0.0)
    total = w.sum(dim=1, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, 1.0),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[:, None], w, torch.zeros_like(w))


def _pos_for_grid(pos: torch.Tensor, base_grid: int, grid: int) -> torch.Tensor:
    """The learned (base_grid^2, D) positional embedding at a serving
    grid: reshaped to 2D, resized bilinearly as ``jax.image.resize``
    does (two separable products with ``_resize_weights``), flattened.
    Deterministic, so an engine forward and its B = 1 replay see the
    same embedding bit for bit; the identity at the native grid."""
    if grid == base_grid:
        return pos
    d = pos.shape[-1]
    w = _resize_weights(base_grid, grid, pos.device)  # (grid, base_grid)
    pos2d = pos.float().reshape(base_grid, base_grid, d)
    rows = torch.einsum("ih,hwd->iwd", w, pos2d)
    out = torch.einsum("jw,iwd->ijd", w, rows)
    return out.reshape(grid * grid, d).to(pos.dtype)


# ---------------------------------------------------------------------------
# Stage pipeline


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """One stage of the ViG pipeline: static geometry + resolved spec."""

    index: int
    depth: int
    grid: int
    r: int
    m: int  # co-nodes per image (grid/r)^2
    spec: DigcSpec  # stage spec, k/dilation still model-owned
    dilations: tuple[int, ...]  # per block, after the m-feasibility clamp
    k_effs: tuple[int, ...]  # per block effective neighbour count

    @property
    def key(self) -> str:
        return f"stage{self.index}"

    @property
    def n(self) -> int:
        return self.grid * self.grid


def _block_geometry(cfg: VigConfig, gb: int, m: int,
                    k: Optional[int] = None, *,
                    grid: Optional[int] = None,
                    base_grid: Optional[int] = None) -> tuple[int, int]:
    """(dilation, k_eff) for global block ``gb`` against ``m`` co-nodes."""
    k = cfg.k if k is None else k
    dil = _dilation_for(cfg, gb, m, k, grid=grid, base_grid=base_grid)
    k_eff = min(k, m // max(dil, 1)) or 1
    if k_eff * dil > m:
        dil = 1
    return dil, k_eff


DigcChoice = Union[str, DigcSpec, VigSchedule, None]


def resolve_digc_spec(cfg: VigConfig, digc_impl: DigcChoice,
                      stage: int = 0) -> DigcSpec:
    """Normalize the model's DIGC choice to a DigcSpec; a spec without
    ``k`` inherits cfg.k. A ``VigSchedule`` (per-stage tuned specs,
    ``core.tuner``) resolves to its entry for ``stage``."""
    choice = digc_impl if digc_impl is not None else cfg.digc_impl
    if isinstance(choice, VigSchedule):
        choice = choice.spec_for(stage)
    if isinstance(choice, DigcSpec):
        return choice if choice.k is not None else choice.replace(k=cfg.k)
    return DigcSpec(impl=choice, k=cfg.k)


def vig_stage_plans(cfg: VigConfig, digc_impl: DigcChoice = None,
                    *, grid: Optional[int] = None) -> tuple[StagePlan, ...]:
    """Materialize the stage pipeline for a model + DIGC choice.

    ``grid`` is the serving patch grid (default: the native one). Raises
    ``VigGridError`` when a stage's grid is not divisible by its reduce
    ratio or, for any stage but the last, by the 2x downsample.
    """
    plans = []
    grid = cfg.base_grid if grid is None else int(grid)
    if grid < 1:
        raise VigGridError(f"serving grid must be >= 1; got {grid}")
    gb = 0
    for si, depth in enumerate(cfg.depths):
        spec = resolve_digc_spec(cfg, digc_impl, si)
        r = cfg.reduce_ratios[si] if si < len(cfg.reduce_ratios) else 1
        if r > 1 and grid % r:
            raise VigGridError(
                f"stage{si}: grid {grid} is not divisible by its "
                f"reduce ratio r={r} (model {cfg.name!r}); serve a "
                f"resolution whose stage grids divide, or drop the "
                f"pooling ratio"
            )
        if si + 1 < len(cfg.depths) and grid % 2:
            raise VigGridError(
                f"stage{si}: grid {grid} is odd but stage{si + 1} "
                f"needs the 2x2 downsample (model {cfg.name!r}); "
                f"serve a resolution divisible through every stage"
            )
        k_s = _resolution_k(spec.k, grid, cfg.grid_at_stage(si))
        spec = spec.replace(k=k_s)
        m = (grid // max(r, 1)) ** 2
        geo = tuple(
            _block_geometry(cfg, gb + bi, m, k_s, grid=grid,
                            base_grid=cfg.grid_at_stage(si))
            for bi in range(depth)
        )
        plans.append(StagePlan(
            index=si, depth=depth, grid=grid, r=r, m=m, spec=spec,
            dilations=tuple(g[0] for g in geo),
            k_effs=tuple(g[1] for g in geo),
        ))
        gb += depth
        if si + 1 < len(cfg.depths):
            grid //= 2
    return tuple(plans)


def grapher_block(bp: dict, x: torch.Tensor, cfg: VigConfig, grid: int,
                  r: int, dilation: int,
                  digc_spec: Optional[DigcSpec] = None,
                  layer_key: Optional[str] = None,
                  state: Optional[DigcState] = None,
                  reuse_first: bool = True,
                  digc_capture: Optional[list] = None,
                  m_valid: Optional[torch.Tensor] = None):
    """x (B, N, D) -> ((B, N, D), state); one Grapher + FFN residual pair.

    ``state`` (a ``DigcState`` keyed by ``layer_key``) is threaded
    through DIGC and returned updated (None stays None); ``reuse_first``
    marks the first block of a stage in a forward pass, the gate point of
    the ``tick`` reuse policy. ``digc_capture`` (a list) collects
    ``(layer_key, h, cond)`` per DIGC call: the nodes and co-nodes (None
    for a self-graph) it was given. ``m_valid`` ((N,) or (B, N) bool)
    marks live nodes when the batch carries pad nodes: DIGC masks the pad
    co-nodes out of every top-k (self-graph stages only; ``vig_forward``
    screens that).
    """
    dspec = digc_spec if digc_spec is not None else resolve_digc_spec(cfg, None)
    h = _ln(x, bp["ln_g"]["scale"])
    h = h @ bp["fc_in"]
    cond = _pool_conodes(h, grid, r)  # None = self-graph
    m = cond.shape[1] if cond is not None else h.shape[1]
    k_eff = min(dspec.k, m // max(dilation, 1)) or 1
    if k_eff * dilation > m:
        dilation = 1
    dspec = dspec.replace(k=k_eff, dilation=dilation).with_grid(grid, grid)
    builder = get_builder(dspec.impl)
    if digc_capture is not None:
        digc_capture.append((layer_key, h, cond))
    # The overlap policy's refresh build runs beside MRConv and the FFN,
    # joined before the block returns its state.
    refresh = RefreshFork() if state is not None else None
    # The build returns integer indices: no gradient flows through it, so
    # autograd holds none of the tier's distance tiles.
    with torch.no_grad():
        if state is not None:
            idx, state = digc(h, cond, spec=dspec, state=state,
                              state_key=layer_key, reuse_first=reuse_first,
                              refresh=refresh, m_valid=m_valid)
        else:
            idx = digc(h, cond, spec=dspec, m_valid=m_valid)  # (B, N, k) int32
    aggregate = builder.aggregate if builder.aggregate is not None else mr_aggregate
    agg = aggregate(h, cond if cond is not None else h, idx)
    h = torch.cat([h, agg], dim=-1) @ bp["fc_graph"]
    h = F.gelu(h, approximate="tanh") @ bp["fc_out"]
    x = x + h
    f = _ln(x, bp["ln_f"]["scale"])
    f = F.gelu(f @ bp["fc1"], approximate="tanh") @ bp["fc2"]
    if refresh is not None:
        refresh.join()
    return x + f, state


def run_stage(stage_params: dict, x: torch.Tensor, cfg: VigConfig,
              plan: StagePlan, *, state: Optional[DigcState] = None,
              digc_capture: Optional[list] = None,
              m_valid: Optional[torch.Tensor] = None):
    """Run one pipeline stage: ``plan.depth`` Grapher+FFN blocks sharing
    the stage's state key. Returns ``(x, state)``."""
    for bi in range(plan.depth):
        x, state = grapher_block(
            stage_params[f"block{bi}"], x, cfg, plan.grid, plan.r,
            plan.dilations[bi], digc_spec=plan.spec, layer_key=plan.key,
            state=state, reuse_first=(bi == 0), digc_capture=digc_capture,
            m_valid=m_valid,
        )
    return x, state


def vig_forward(params: dict, images: torch.Tensor, cfg: VigConfig, *,
                digc_impl: DigcChoice = None,
                state: Optional[DigcState] = None,
                digc_capture: Optional[list] = None,
                valid_mask: Optional[torch.Tensor] = None):
    """images (B, H, W, C) -> class logits (B, num_classes), or
    ``(logits, new_state)`` when ``state`` is given.

    patchify -> stem + positional embedding -> per stage, Grapher blocks
    -> 2x2 downsample between stages -> mean pool -> head. Runs on the
    device of ``params`` and ``images``. ``digc_impl`` is a builder name,
    a DigcSpec or a ``VigSchedule`` resolved per stage. ``state`` (see
    ``init_vig_state``) carries construction state across blocks and
    requests: feeding the returned state into the next call warm-starts
    it. ``digc_capture`` collects every DIGC call's ``(layer_key, nodes,
    co_nodes)``.

    The serving grid is the image's: square, divisible by ``cfg.patch``
    and accepted by ``vig_stage_plans`` (``VigGridError`` otherwise); off
    the native grid the positional embedding is resampled
    (``_pos_for_grid``) and k and the dilation ramp per stage.
    ``valid_mask`` ((N,) or (B, N) bool; a device tensor is used as it
    is, so a captured program may take it as a static input) marks live
    nodes of images zero-padded up to a larger grid: pad nodes are
    masked out of every DIGC top-k and the mean pooling. Single-stage
    models with r = 1 only (pooling and downsampling would mix pad and
    live rows): others raise ``VigGridError``.
    """
    b, hh, ww, _ = images.shape
    if hh != ww:
        raise VigGridError(
            f"vig_forward needs square inputs; got H={hh}, W={ww} "
            f"(pad to a square N-bucket upstream)"
        )
    if hh % cfg.patch:
        raise VigGridError(
            f"image size {hh} is not divisible by patch={cfg.patch}"
        )
    grid0 = hh // cfg.patch
    plans = vig_stage_plans(cfg, digc_impl, grid=grid0)
    if valid_mask is not None and (
        len(cfg.depths) > 1 or any(p.r > 1 for p in plans)
    ):
        raise VigGridError(
            f"valid_mask (N-bucket pad nodes) requires a single-stage "
            f"model with r=1 — pooling/downsampling mixes pad and live "
            f"rows; model {cfg.name!r} has depths={cfg.depths}, "
            f"reduce_ratios={cfg.reduce_ratios}"
        )
    mask = None
    if valid_mask is not None:
        mask = live_mask(valid_mask, images.device)
    x = patchify(images, cfg.patch) @ params["stem"]
    x = x + _pos_for_grid(params["pos"], cfg.base_grid, grid0)
    for plan in plans:
        x, state = run_stage(params[plan.key], x, cfg, plan, state=state,
                             digc_capture=digc_capture, m_valid=mask)
        if plan.index + 1 < len(cfg.depths):
            x = _downsample(x, plan.grid, params[f"down{plan.index}"])
    if mask is None:
        pooled = x.mean(dim=1)
    else:
        w = (mask[None, :] if mask.ndim == 1 else mask).to(x.dtype)[..., None]
        pooled = (x * w).sum(dim=1) / w.sum(dim=1).clamp_min(1.0)
    logits = pooled @ params["head"]
    if state is not None:
        return logits, state
    return logits


def init_vig_state(cfg: VigConfig, batch: int,
                   digc_impl: DigcChoice = None, *, per_slot: bool = False,
                   grid: Optional[int] = None, device="cuda") -> DigcState:
    """The functional DIGC state for a model and batch size, on
    ``device``: one entry per stage (the key ``grapher_block`` passes)
    with a cold step counter, and a (batch, C, D) centroid buffer for a
    stage on the ``cluster`` tier (C from ``default_cluster_params`` on
    the stage's co-node count, as the builder derives it).

    ``per_slot=True`` adds (batch,) per-row counters on every entry, the
    multi-tenant serving layout: each batch row is a slot whose warm/cold
    validity is tracked on its own. A stage whose spec carries a
    ``reuse`` policy gets the stale-graph buffers, sized by the stage's
    first block ``(batch, plan.n, plan.k_effs[0])``, as
    ``grapher_block`` derives it (a later block whose clamped k differs
    never engages the cache). ``grid`` sizes the state for a serving grid
    (default: the native one): the multi-resolution engine keeps one
    state per image size, each sized by the plans its forward runs.
    """
    rows = batch if per_slot else None
    entries = {}
    for plan in vig_stage_plans(cfg, digc_impl, grid=grid):
        spec = plan.spec
        cents = None
        if spec.impl == "cluster":
            n_clusters, _ = default_cluster_params(plan.m, spec.n_clusters,
                                                   spec.n_probe)
            cents = (batch, n_clusters, cfg.embed_dims[plan.index])
        policy, _, _ = reuse_params(spec)
        graph = (batch, plan.n, plan.k_effs[0]) if policy is not None else None
        entries[plan.key] = state_entry(centroids_shape=cents, rows=rows,
                                        graph_shape=graph, device=device)
    return DigcState.init(entries)


def vig_loss_fn(params: dict, batch, cfg: VigConfig):
    """Mean softmax cross entropy of ``vig_forward``'s fp32 logits against
    ``batch["labels"]`` -> (loss, {}). Training drives the functional
    forward with a parameter dict that requires grad (``Vig`` is
    inference-only)."""
    logits = vig_forward(params, batch["images"], cfg)
    return softmax_xent(logits, batch["labels"]).mean(), {}


def count_digc_work(cfg: VigConfig, *, grid: Optional[int] = None) -> list:
    """Per-image DIGC workload (N, M, D, k, dilation) per block, read from
    the same ``vig_stage_plans`` the forward executes."""
    out = []
    for plan in vig_stage_plans(cfg, grid=grid):
        d = cfg.embed_dims[plan.index]
        for bi in range(plan.depth):
            out.append({
                "stage": plan.index, "N": plan.n, "M": plan.m, "D": d,
                "k": plan.spec.k, "dilation": plan.dilations[bi],
            })
    return out


class Vig(nn.Module):
    """A ViG backbone as an ``nn.Module``: holds the parameters and runs
    ``vig_forward`` with its DIGC choice.

    ``params`` is a nested parameter dict (``convert.init_params`` or
    ``convert.params_from_numpy``); None draws a seeded init. Inference
    only: the parameters do not require grad.
    """

    def __init__(self, cfg: VigConfig, params: Optional[dict] = None, *,
                 digc_impl: DigcChoice = "cuda", seed: int = 0,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        if params is None:
            params = init_params(cfg, generator=torch.Generator().manual_seed(seed),
                                 device=dev)
        self.cfg = cfg
        self.digc_impl = digc_impl
        self.weights = nn.ParameterDict({
            path: nn.Parameter(t.to(dev), requires_grad=False)
            for path, t in flatten(params).items()
        })

    def params(self) -> dict:
        """The parameters as the nested dict ``vig_forward`` takes."""
        return unflatten(dict(self.weights.items()))

    def forward(self, images: torch.Tensor, *,
                state: Optional[DigcState] = None,
                digc_capture: Optional[list] = None,
                valid_mask: Optional[torch.Tensor] = None):
        """Logits, or ``(logits, new_state)`` when ``state`` is given
        (``init_vig_state(cfg, batch, self.digc_impl)``); ``valid_mask``
        marks the live nodes of zero-padded images (``vig_forward``)."""
        return vig_forward(self.params(), images, self.cfg,
                           digc_impl=self.digc_impl, state=state,
                           digc_capture=digc_capture, valid_mask=valid_mask)
