"""Mixture-of-Experts (port of ``repro/models/moe.py``): the fp32 router
with its Switch load-balance loss, the shared experts, and three paths:

* no mesh, or a mesh whose model axis is 1, and no input that autograd
  records: routed experts (``_routed_moe``). Each selected (token, expert)
  pair is computed once: the pairs are grouped by expert on the device
  and the selected experts' products run in a hand-written kernel
  (``kernels/moe_experts.py``; the plain PyTorch version on the CPU). Rows
  that ``live`` marks dead enter no group. Nothing drops;
* the same, with an input that requires grad (training), or on ``meta``
  tensors (the dry-run, whose shapes cannot depend on the routing): every
  expert on every token weighted by the zeroed combine matrix
  (``_dense_moe``, JAX's single-device path, the capacity-unlimited
  reference: nothing drops). The kernel has no backward;
* a mesh with a model axis larger than 1: expert parallelism
  (``_local_expert_moe``). SPMD over ``torch.distributed``: every rank
  holds the global tokens and weights, takes its batch rows (split over
  the mesh's ``pod`` / ``data`` axes) and its ``E / |model|`` experts,
  routes its rows, packs the tokens bound for its experts into
  fixed-capacity buffers in token-order priority (overflow goes to a
  dropped row, GShard's semantics), runs the expert products, and an
  all-reduce over the model axis combines the experts' outputs; the rows
  are gathered back, so every rank returns the global output.

The paths share only ``_router``. Top-k follows ``lax.top_k``: ties go to
the lowest expert index (a stable descending sort; ``torch.topk`` promises
no order among equal values).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import spans
from repro_torch.kernels.moe_experts import moe_experts
from repro_torch.launch.mesh import all_gather, all_reduce
from repro_torch.models.config import ModelConfig
from repro_torch.models.module import active_mesh, leaves, spec


def moe_spec(cfg: ModelConfig):
    m = cfg.moe
    d, e, f = cfg.d_model, m.num_experts, m.d_expert
    s = {
        "router": spec((d, e), ("embed", None), init="fanin",
                       dtype=torch.float32),
        "w_gate": spec((e, d, f), ("experts", "embed", "expert_mlp")),
        "w_up": spec((e, d, f), ("experts", "embed", "expert_mlp")),
        "w_down": spec((e, f, d), ("experts", "expert_mlp", "embed")),
    }
    if m.num_shared:
        fs = m.d_expert * m.num_shared
        s["shared"] = {
            "wi_gate": spec((d, fs), ("embed", "mlp")),
            "wi_up": spec((d, fs), ("embed", "mlp")),
            "wo": spec((fs, d), ("mlp", "embed")),
        }
    return s


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest values in descending
    order with their indices, equal values in ascending index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(params, tokens: torch.Tensor, m, norm_topk: bool = True):
    """tokens (T, D) -> (gates (T,k), sel (T,k), aux_loss, probs). The
    gates are the top-k softmax probabilities, renormalised to sum to 1
    unless ``norm_topk`` is False (``DeepSeekV2Config.norm_topk``)."""
    logits = tokens.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gates, sel = top_k(probs, m.top_k)
    if norm_topk:
        gates = gates / gates.sum(-1, keepdim=True)
    # Switch load-balance loss: E * sum_e f_e * p_e, f_e from the primary
    # assignment (a comparison, where JAX one-hots: no device read)
    e = probs.shape[-1]
    experts = torch.arange(e, device=sel.device)
    f_e = (sel[:, :1] == experts).float().mean(0)
    p_e = probs.mean(0)
    aux = e * (f_e * p_e).sum()
    return gates, sel, aux, probs


def _dense_moe(params, x: torch.Tensor, cfg: ModelConfig):
    """Every expert on every token, weighted by the zeroed combine matrix
    (T, E): gate where selected, else 0."""
    m = cfg.moe
    dt = cfg.compute_dtype
    b, s, d = x.shape
    tokens = x.reshape(-1, d)
    gates, sel, aux, _ = _router(params, tokens, m,
                                 getattr(cfg, "norm_topk", True))
    comb = torch.zeros(tokens.shape[0], m.num_experts, dtype=torch.float32,
                       device=x.device).scatter_add_(1, sel, gates)
    # (E, T, F) by batched products over the experts: the stacked weights
    # are read where they lie (an einsum would permute them into a copy)
    h_g = tokens @ params["w_gate"].to(dt)
    h_u = tokens @ params["w_up"].to(dt)
    h = F.silu(h_g) * h_u
    y_e = h @ params["w_down"].to(dt)  # (E, T, D)
    out = torch.einsum("etd,te->td", y_e.float(), comb).to(dt)
    metrics = {"moe_aux": aux,
               "moe_drop_frac": torch.zeros((), dtype=torch.float32,
                                            device=x.device)}
    return out.reshape(b, s, d), metrics


def _routed_moe(params, x: torch.Tensor, cfg: ModelConfig,
                live: Optional[torch.Tensor] = None):
    """Each live (token, expert) pair once, grouped by expert on the device
    (``kernels/moe_experts.py``): h and y rounded to the compute dtype, the
    gates applied in fp32, as ``_dense_moe``. ``live`` (B,) bool: a dead
    row's tokens enter no expert group and get 0."""
    m = cfg.moe
    dt = cfg.compute_dtype
    b, s, d = x.shape
    tokens = x.reshape(-1, d)
    gates, sel, aux, _ = _router(params, tokens, m,
                                 getattr(cfg, "norm_topk", True))
    if live is not None:
        live = live.reshape(b, 1).expand(b, s).reshape(-1)
    out = moe_experts(tokens.to(dt), params["w_gate"].to(dt),
                      params["w_up"].to(dt), params["w_down"].to(dt), sel,
                      gates, live)
    metrics = {"moe_aux": aux,
               "moe_drop_frac": torch.zeros((), dtype=torch.float32,
                                            device=x.device)}
    return out.reshape(b, s, d), metrics


def _routes(params, x: torch.Tensor) -> bool:
    """Whether ``moe_apply`` takes the routed path: no input that autograd
    records (the kernel has no backward) and tensors with storage (the
    dry-run's ``meta`` tensors keep the dense form)."""
    if x.device.type == "meta":
        return False
    return not (torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in leaves(params).values())))


def _local_expert_moe(x_loc, router_w, w_gate, w_up, w_down, *, m, dt,
                      mesh, axis_name: str, n_shards: int,
                      norm_topk: bool = True):
    """One rank's rows through its expert shard. x_loc (b_loc, s, d);
    w_* the rank's (E_loc, ...) experts. Returns (out summed over the
    model axis, aux of these rows, drop fraction over the model axis)."""
    b, s, d = x_loc.shape
    tokens = x_loc.reshape(-1, d)
    t, k = tokens.shape[0], m.top_k
    e_loc = w_gate.shape[0]
    e = e_loc * n_shards
    e0 = mesh.coordinate(axis_name) * e_loc

    probs = torch.softmax(tokens.float() @ router_w.float(), dim=-1)
    gates, sel = top_k(probs, k)
    if norm_topk:
        gates = gates / gates.sum(-1, keepdim=True)
    experts = torch.arange(e, device=sel.device)
    aux = e * ((sel[:, :1] == experts).float().mean(0) * probs.mean(0)).sum()

    cap = max(int(t * k / e * m.capacity_factor), 4)
    # local expert ids; out of range -> the overflow row
    lid = sel - e0  # (T, k)
    in_range = (lid >= 0) & (lid < e_loc)
    lid_c = torch.where(in_range, lid, torch.zeros_like(lid))
    # position of each (t, j) within its expert, priority by token order
    onehot = F.one_hot(lid_c, e_loc) * in_range[..., None]
    flat = onehot.reshape(t * k, e_loc)
    pos = torch.cumsum(flat, dim=0) - flat  # entries before this one
    pos_sel = (pos * flat).sum(1).reshape(t, k)
    keep = in_range & (pos_sel < cap)
    dropped = (in_range & (pos_sel >= cap)).sum().float()

    slot = torch.where(keep, lid_c * cap + pos_sel,
                       torch.full_like(lid_c, e_loc * cap)).reshape(-1)
    tok_idx = torch.arange(t, device=tokens.device).repeat_interleave(k)
    buf = torch.zeros(e_loc * cap + 1, d, dtype=dt, device=tokens.device)
    buf.index_add_(0, slot, tokens[tok_idx].to(dt))
    buf = buf[:e_loc * cap].reshape(e_loc, cap, d)

    h = F.silu(buf @ w_gate.to(dt)) * (buf @ w_up.to(dt))
    y = h @ w_down.to(dt)  # (E_loc, cap, d)
    y_flat = torch.cat([y.reshape(e_loc * cap, d), y.new_zeros(1, d)])
    gathered = y_flat[slot].reshape(t, k, d)
    w = torch.where(keep, gates, torch.zeros_like(gates))
    out = (gathered.float() * w[..., None]).sum(1)
    out = all_reduce(out.to(dt), mesh, axis_name)
    dropped = all_reduce(dropped, mesh, axis_name) / float(t * k)
    return out.reshape(b, s, d), aux, dropped


def _expert_parallel(params, x, cfg: ModelConfig, mesh, model_axis: str):
    """``_local_expert_moe`` on this rank's rows and experts, the rows
    gathered back. The metrics are those of the first batch shard on
    every rank, as JAX's replicated ``out_specs`` read device 0's."""
    m = cfg.moe
    n_shards = mesh.shape[model_axis]
    assert m.num_experts % n_shards == 0, (m.num_experts, n_shards)
    e_loc = m.num_experts // n_shards
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    shards, shard = 1, 0
    for a in batch_axes:
        shards, shard = shards * mesh.shape[a], shard * mesh.shape[a] + \
            mesh.coordinate(a)
    b_loc = x.shape[0] // shards
    e0 = mesh.coordinate(model_axis) * e_loc
    experts = slice(e0, e0 + e_loc)
    out, aux, drop = _local_expert_moe(
        x[shard * b_loc:(shard + 1) * b_loc], params["router"],
        params["w_gate"][experts], params["w_up"][experts],
        params["w_down"][experts], m=m, dt=cfg.compute_dtype, mesh=mesh,
        axis_name=model_axis, n_shards=n_shards,
        norm_topk=getattr(cfg, "norm_topk", True))
    metrics = torch.stack([aux, drop])[None]
    for a in reversed(batch_axes):  # innermost axis first: row-major order
        out = all_gather(out, mesh, a, 0)
        metrics = all_gather(metrics, mesh, a, 0)
    return out, {"moe_aux": metrics[0, 0], "moe_drop_frac": metrics[0, 1]}


def moe_apply(params, x: torch.Tensor, cfg: ModelConfig, *, mesh=None,
              model_axis: str = "model", live: Optional[torch.Tensor] = None):
    """Returns (out, {"moe_aux", "moe_drop_frac"}), the shared experts
    added. Expert-parallel when ``mesh`` (default: the ``use_mesh``
    context's) has a ``model_axis`` larger than 1, else routed or dense
    (``_routes``; a dense call counted under ``spans.MOE_DENSE_CALLS``).
    ``live`` (B,) bool or None (every row): a dead row's output is the
    shared experts' alone."""
    m = cfg.moe
    dt = cfg.compute_dtype
    mesh = mesh or active_mesh()
    if (mesh is not None and model_axis in mesh.axis_names
            and mesh.shape[model_axis] > 1):
        out, metrics = _expert_parallel(params, x, cfg, mesh, model_axis)
    elif _routes(params, x):
        out, metrics = _routed_moe(params, x, cfg, live)
        live = None  # applied
    else:
        if spans.RECORDER.enabled:
            spans.RECORDER.count(spans.MOE_DENSE_CALLS)
        out, metrics = _dense_moe(params, x, cfg)
    if live is not None:
        out = torch.where(live[:, None, None], out, 0.0)
    if m.num_shared:
        sh = params["shared"]
        g = x @ sh["wi_gate"].to(dt)
        u = x @ sh["wi_up"].to(dt)
        out = out + (F.silu(g) * u) @ sh["wo"].to(dt)
    return out, metrics
