"""Griffin / RecurrentGemma RG-LRU recurrent block (port of
``repro/models/griffin.py``); the model interleaves it with local
attention, (rec, rec, attn), in ``models/transformer.py``.

Prefill runs the linear recurrence h_t = a_t h_{t-1} + beta_t as a
log-depth scan over time with JAX's ``combine`` (JAX: ``lax.associative_
scan``; the fp32 sums come in another order); decode carries (h, conv)
per row. Plain PyTorch: JAX's block is einsums and the scan, no Pallas
kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.module import spec


def _lru_width(cfg: ModelConfig) -> int:
    return cfg.hybrid.lru_width or cfg.d_model


def rglru_spec(cfg: ModelConfig):
    d = cfg.d_model
    w = _lru_width(cfg)
    k = cfg.hybrid.d_conv
    return {
        "w_x": spec((d, w), ("embed", "mlp")),
        "w_gate_branch": spec((d, w), ("embed", "mlp")),
        "conv_w": spec((k, w), ("conv", "mlp"), init="fanin"),
        "conv_b": spec((w,), ("mlp",), init="zeros"),
        "w_input_gate": spec((w, w), ("mlp", None), init="fanin"),
        "b_input_gate": spec((w,), (None,), init="zeros"),
        "w_rec_gate": spec((w, w), ("mlp", None), init="fanin"),
        "b_rec_gate": spec((w,), (None,), init="zeros"),
        "lam": spec((w,), ("mlp",), init="normal", scale=1.0),
        "w_out": spec((w, d), ("mlp", "embed")),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """u (B,S,W), w (K,W): depthwise causal conv along S (no activation)."""
    k, s = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, k - 1, 0))
    return sum(pad[:, i:i + s, :] * w[i] for i in range(k)) + b


def _gates(params, u: torch.Tensor, cfg: ModelConfig):
    """The recurrence's decay ``a`` and input ``beta``, in fp32."""
    c = cfg.hybrid.c_factor
    u32 = u.float()
    i_gate = torch.sigmoid(u32 @ params["w_input_gate"].float()
                           + params["b_input_gate"].float())
    r_gate = torch.sigmoid(u32 @ params["w_rec_gate"].float()
                           + params["b_rec_gate"].float())
    log_a = c * r_gate * F.logsigmoid(params["lam"].float())
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i_gate * u32)
    return a, beta


def _linear_scan(a: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + beta_t from h_{-1} = 0 along axis 1: a
    Hillis-Steele scan with ``combine((al, bl), (ar, br)) = (al ar,
    bl ar + br)``, ceil(log2 S) steps."""
    s = a.shape[1]
    step = 1
    while step < s:
        a_prev, b_prev = a[:, :-step], beta[:, :-step]
        a_tail, b_tail = a[:, step:], beta[:, step:]
        a = torch.cat([a[:, :step], a_prev * a_tail], dim=1)
        beta = torch.cat([beta[:, :step], b_prev * a_tail + b_tail], dim=1)
        step *= 2
    return beta


def rglru_apply(params, x: torch.Tensor, cfg: ModelConfig, *,
                state: Optional[dict] = None):
    """Recurrent block. prefill: state=None -> (out, {"h": (B,W) fp32,
    "conv": (B,K-1,W) fp32}); decode: state = {"h", "conv"}, x (B,1,D) ->
    (out, new_state)."""
    dt = cfg.compute_dtype
    k = cfg.hybrid.d_conv
    ub = x @ params["w_x"].to(dt)
    gate_branch = F.gelu(x @ params["w_gate_branch"].to(dt),
                         approximate="tanh")  # jax.nn.gelu's default

    if state is None:
        u = _causal_conv(ub, params["conv_w"].to(dt), params["conv_b"].to(dt))
        a, beta = _gates(params, u, cfg)  # (B,S,W) fp32
        h = _linear_scan(a, beta)
        out = (gate_branch.float() * h).to(dt) @ params["w_out"].to(dt)
        seq = x.shape[1]
        tail = (ub[:, -(k - 1):, :] if seq >= k - 1
                else F.pad(ub, (0, 0, k - 1 - seq, 0)))
        return out, {"h": h[:, -1].float(), "conv": tail.float()}

    # ---- decode
    window = torch.cat([state["conv"].to(dt), ub], dim=1)  # (B,K,W)
    u = (torch.einsum("bkw,kw->bw", window, params["conv_w"].to(dt))
         + params["conv_b"].to(dt))[:, None, :]
    a, beta = _gates(params, u, cfg)  # (B,1,W)
    h = state["h"] * a[:, 0] + beta[:, 0]
    out = (gate_branch.float() * h[:, None]).to(dt) @ params["w_out"].to(dt)
    conv_new = torch.cat([state["conv"][:, 1:], ub.float()], dim=1)
    return out, {"h": h, "conv": conv_new}


def rglru_init_state(cfg: ModelConfig, batch: int, *, device="cuda"):
    """Zeroed decode state, fp32: ``h`` (B,W), ``conv`` (B,K-1,W)."""
    w = _lru_width(cfg)
    dev = resolve_device(device)
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=dev),
        "conv": torch.zeros((batch, cfg.hybrid.d_conv - 1, w),
                            dtype=torch.float32, device=dev),
    }
