"""AdamW with fp32 master weights, cosine schedule, global-norm clip (port
of ``repro/train/optimizer.py``).

Trees are the parameters' nested dicts of tensors; the state lives on the
parameters' device. ``OptState`` keeps JAX's field order, which the
checkpoint format depends on (``opt/0`` is ``step``, ``opt/1/...`` is
``mu``). The update is functional: it returns new tensors and leaves the
state passed in as it was. ``torch.optim.AdamW`` is not used: it places
eps elsewhere and keeps no master copy and no clip.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, NamedTuple, Optional

import torch

from repro_torch.models import module


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    mu: Any  # first moment (fp32)
    nu: Any  # second moment (fp32)
    master: Any  # fp32 master copy of the parameters


def _zip_map(fn, tree: Mapping, *others: Mapping) -> dict:
    """``fn(leaf, *the others' leaves at its path)`` over nested dicts,
    keeping ``tree``'s structure (empty sub-dicts too)."""
    flat = [module.leaves(o) for o in others]
    return module.map_tree(lambda path, t: fn(t, *(f[path] for f in flat)),
                           tree)


def lr_at(step, oc: OptConfig) -> torch.Tensor:
    """Linear warmup to ``oc.lr``, then cosine down to ``min_lr_frac`` of
    it at ``total_steps``: an fp32 scalar at ``step`` (int or tensor)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(oc.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - oc.warmup_steps)
                       / max(oc.total_steps - oc.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return oc.lr * warm * (oc.min_lr_frac + (1 - oc.min_lr_frac) * cos)


def init_opt_state(params: Mapping) -> OptState:
    leaves = list(module.leaves(params).values())
    device = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        mu=_zip_map(zeros, params),
        nu=_zip_map(zeros, params),
        master=_zip_map(lambda p: p.detach().to(torch.float32, copy=True),
                        params),
    )


def global_norm(tree: Mapping) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32 (leaves in JAX's
    order: sorted keys)."""
    flat = module.leaves(tree)
    return torch.sqrt(sum(flat[p].float().square().sum() for p in sorted(flat)))


@torch.no_grad()
def adamw_update(grads: Mapping, opt_state: OptState, oc: OptConfig,
                 params_dtype: Optional[torch.dtype] = None):
    """Returns (new_params, new_opt_state, metrics): the grads clipped to
    ``clip_norm`` by their global norm, bias corrections ``1 - b^step`` in
    fp32 from the int32 step, decoupled weight decay on every leaf, the
    fp32 master updated and the new parameters cast from it to
    ``params_dtype`` (None: each grad's dtype). ``metrics``: ``grad_norm``
    (before the clip) and ``lr``."""
    step = opt_state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(oc.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = lr_at(step, oc).to(gnorm.device)
    b1, b2 = oc.b1, oc.b2
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())

    def upd(g, mu, nu, master):
        g = g.float() * scale
        mu = (b1 * mu).add_((1 - b1) * g)
        nu = (b2 * nu).add_((1 - b2) * g * g)
        denom = (nu / bc2).sqrt_().add_(oc.eps)
        delta = (mu / bc1).div_(denom).add_(oc.weight_decay * master)
        return mu, nu, master - lr * delta

    out = _zip_map(upd, grads, opt_state.mu, opt_state.nu, opt_state.master)
    flat = module.leaves(out)
    pick = lambda i: module.map_tree(lambda path, _: flat[path][i], grads)
    mu, nu, master = pick(0), pick(1), pick(2)
    new_params = _zip_map(
        lambda w, g: w.to(g.dtype if params_dtype is None else params_dtype),
        master, grads)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_params, OptState(step, mu, nu, master), metrics
