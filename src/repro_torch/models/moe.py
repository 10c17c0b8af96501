"""Mixture-of-Experts (port of ``repro/models/moe.py``): the fp32 router
with its Switch load-balance loss, every expert on every token weighted by
the zeroed combine matrix, and the shared experts.

This is the function JAX computes on one device (``_dense_moe``, the
capacity-unlimited reference: nothing is dropped). JAX's expert-parallel
path (``_local_expert_moe`` under ``shard_map``, fixed-capacity buffers
that drop overflow) needs a mesh: ``moe_apply(mesh=)`` with a model axis
larger than 1 raises ``NotImplementedError`` naming the ROADMAP item that
ports it; nothing runs the dense form in its place.

Top-k follows ``lax.top_k``: ties go to the lowest expert index (a stable
descending sort; ``torch.topk`` promises no order among equal values).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.module import spec


def moe_spec(cfg: ModelConfig):
    m = cfg.moe
    d, e, f = cfg.d_model, m.num_experts, m.d_expert
    s = {
        "router": spec((d, e), init="fanin", dtype=torch.float32),
        "w_gate": spec((e, d, f)),
        "w_up": spec((e, d, f)),
        "w_down": spec((e, f, d)),
    }
    if m.num_shared:
        fs = m.d_expert * m.num_shared
        s["shared"] = {
            "wi_gate": spec((d, fs)),
            "wi_up": spec((d, fs)),
            "wo": spec((fs, d)),
        }
    return s


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest values in descending
    order with their indices, equal values in ascending index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(params, tokens: torch.Tensor, m):
    """tokens (T, D) -> (gates (T,k), sel (T,k), aux_loss, probs)."""
    logits = tokens.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gates, sel = top_k(probs, m.top_k)
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
    gates, sel, aux, _ = _router(params, tokens, m)
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


def moe_apply(params, x: torch.Tensor, cfg: ModelConfig, *, mesh=None,
              model_axis: str = "model"):
    """Returns (out, {"moe_aux", "moe_drop_frac"}), the shared experts
    added. ``mesh`` exposes ``axis_names`` and a ``shape`` mapping, as a
    JAX mesh does; one whose ``model_axis`` is larger than 1 raises: the
    expert-parallel dispatch is not ported."""
    m = cfg.moe
    dt = cfg.compute_dtype
    if (mesh is not None and model_axis in mesh.axis_names
            and mesh.shape[model_axis] > 1):
        raise NotImplementedError(
            f"{cfg.name!r}: expert-parallel MoE over a mesh's {model_axis!r} "
            "axis (models/moe.py::_local_expert_moe) waits for the mesh "
            "slice of the port (ROADMAP queue 1, item 6)")
    out, metrics = _dense_moe(params, x, cfg)
    if m.num_shared:
        sh = params["shared"]
        g = x @ sh["wi_gate"].to(dt)
        u = x @ sh["wi_up"].to(dt)
        out = out + (F.silu(g) * u) @ sh["wo"].to(dt)
    return out, metrics
