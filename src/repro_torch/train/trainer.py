"""Train step: loss + grad + AdamW, with microbatch gradient accumulation
and bf16 params / fp32 master (port of ``repro/train/trainer.py``).

The step runs eagerly: the gradients come from ``torch.autograd.grad`` of
the loss over the parameter leaves, each in its leaf's dtype, as
``jax.value_and_grad`` gives them (a leaf the loss does not reach gets a
zero gradient)."""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch

from repro_torch.models import module
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import loss_fn as lm_loss_fn
from repro_torch.train.optimizer import (
    OptConfig,
    OptState,
    adamw_update,
    init_opt_state,
)


def value_and_grad(loss_fn: Callable, params: Mapping, batch: Mapping, cfg):
    """(loss, metrics, grads) of ``loss_fn(params, batch, cfg)``: the loss
    and metrics detached, the grads a tree like ``params``."""
    flat = module.leaves(params)
    live = {path: t.detach().requires_grad_() for path, t in flat.items()}
    with torch.enable_grad():
        loss, metrics = loss_fn(module.map_tree(lambda path, _: live[path],
                                                params), batch, cfg)
        grads = torch.autograd.grad(loss, list(live.values()),
                                    allow_unused=True)
    by_path = {path: torch.zeros_like(t) if g is None else g
               for (path, t), g in zip(live.items(), grads)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            module.map_tree(lambda path, _: by_path[path], params))


def make_train_step(cfg: ModelConfig, oc: OptConfig,
                    loss_fn: Optional[Callable] = None,
                    accum_steps: int = 1,
                    param_dtype: Optional[torch.dtype] = torch.bfloat16):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics). With accum_steps > 1 the batch's leading dim is split into
    microbatches run one after another, their grads summed in fp32 and
    divided by ``accum_steps``; metrics are then loss, grad_norm and lr
    only, as JAX's."""
    loss_fn = loss_fn or lm_loss_fn

    def train_step(params, opt_state: OptState, batch: Mapping):
        if accum_steps == 1:
            loss, metrics, grads = value_and_grad(loss_fn, params, batch, cfg)
        else:
            def split(x):
                return x.reshape((accum_steps, x.shape[0] // accum_steps)
                                 + tuple(x.shape[1:]))

            mbs = {k: split(v) for k, v in batch.items()}
            grads = module.map_tree(
                lambda _, p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
            losses = []
            for i in range(accum_steps):
                mb_loss, _, mb_grads = value_and_grad(
                    loss_fn, params, {k: v[i] for k, v in mbs.items()}, cfg)
                flat = module.leaves(mb_grads)
                grads = module.map_tree(
                    lambda path, a: a + flat[path].float(), grads)
                losses.append(mb_loss)
            grads = module.map_tree(lambda _, g: g / accum_steps, grads)
            loss = sum(losses) / accum_steps
            metrics = {}

        new_params, new_opt, opt_metrics = adamw_update(
            grads, opt_state, oc, params_dtype=param_dtype)
        return new_params, new_opt, {"loss": loss, **opt_metrics, **metrics}

    return train_step


def init_train_state(params: Mapping) -> OptState:
    return init_opt_state(params)
