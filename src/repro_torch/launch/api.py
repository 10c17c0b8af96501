"""Model API bundle (port of ``repro/launch/api.py``): uniform
(param_spec, prefill, decode, init_cache) for the decoder families the
port runs, used by the serving driver. Training's ``loss_fn`` waits for
the training port; an unported family raises here."""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

from repro_torch.models import transformer as tr
from repro_torch.models.config import ModelConfig


class ModelAPI(NamedTuple):
    param_spec: Callable[[], Any]
    prefill_fn: Callable  # (params, batch) -> (logits, cache)
    decode_fn: Callable  # (params, cache, tokens, pos) -> (logits, cache)
    init_cache: Callable  # (batch, max_len, device=) -> cache


def get_api(cfg: ModelConfig) -> ModelAPI:
    tr.check_ported(cfg)

    def prefill_fn(params, batch):
        return tr.prefill(params, batch["tokens"], cfg,
                          positions=batch.get("positions"))

    return ModelAPI(
        param_spec=lambda: tr.param_spec(cfg),
        prefill_fn=prefill_fn,
        decode_fn=lambda p, c, t, pos, positions=None: tr.decode_step(
            p, c, t, pos, cfg, positions=positions),
        init_cache=lambda batch, max_len, device="cuda": tr.init_cache(
            cfg, batch, max_len, device=device),
    )
