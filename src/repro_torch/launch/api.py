"""Model API bundle (port of ``repro/launch/api.py``): uniform
(param_spec, loss, prefill, decode, init_cache) per family, used by the
train and serve drivers. The encoder-decoder (family ``audio``) prefills
from ``batch["frames"]`` and ``batch["tokens"]``, and its ``init_cache``
takes the memory's length ``enc_len`` (default ``max_source_positions``).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

from repro_torch.models import encdec as ed
from repro_torch.models import transformer as tr
from repro_torch.models.config import ModelConfig


class ModelAPI(NamedTuple):
    param_spec: Callable[[], Any]
    loss_fn: Callable  # (params, batch, cfg) -> (loss, metrics)
    prefill_fn: Callable  # (params, batch) -> (logits, cache)
    decode_fn: Callable  # (params, cache, tokens, pos) -> (logits, cache)
    init_cache: Callable  # (batch, max_len, device=) -> cache


def get_api(cfg: ModelConfig) -> ModelAPI:
    tr.check_ported(cfg)
    if cfg.family == "audio":
        def prefill_fn(params, batch):
            memory = ed.encode(params, batch["frames"], cfg)
            return ed.decode_forward(params, batch["tokens"], memory, cfg,
                                     return_cache=True)

        def init_cache(batch, max_len, enc_len=None, device="cuda"):
            enc_len = enc_len or cfg.encdec.max_source_positions
            return ed.encdec_init_cache(cfg, batch, max_len, enc_len,
                                        device=device)

        return ModelAPI(
            param_spec=lambda: ed.encdec_param_spec(cfg),
            loss_fn=ed.encdec_loss_fn,
            prefill_fn=prefill_fn,
            decode_fn=lambda p, c, t, pos: ed.encdec_decode_step(p, c, t, pos,
                                                                 cfg),
            init_cache=init_cache,
        )

    def prefill_fn(params, batch):
        return tr.prefill(params, batch["tokens"], cfg,
                          positions=batch.get("positions"))

    return ModelAPI(
        param_spec=lambda: tr.param_spec(cfg),
        loss_fn=tr.loss_fn,
        prefill_fn=prefill_fn,
        decode_fn=lambda p, c, t, pos, positions=None: tr.decode_step(
            p, c, t, pos, cfg, positions=positions),
        init_cache=lambda batch, max_len, device="cuda": tr.init_cache(
            cfg, batch, max_len, device=device),
    )
