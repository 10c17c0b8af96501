"""Mamba-2 (state-space duality / SSD) layer (port of ``repro/models/ssm.py``).

Chunked SSD for prefill (intra-chunk quadratic + inter-chunk linear state
recurrence, a loop over the chunks where JAX scans) and a one-token
stateful decode step. Shapes follow the minimal-SSD formulation: heads
H = d_inner / head_dim, scalar decay per head, B/C shared across heads
(n_groups = 1). Plain PyTorch: JAX's layer is einsums, ``cumsum`` and
``lax.scan``, no Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.module import spec


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    heads = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return s, d_in, heads, conv_dim


def ssm_spec(cfg: ModelConfig):
    s, d_in, heads, conv_dim = _dims(cfg)
    d = cfg.d_model
    return {
        "in_proj": spec((d, 2 * d_in + 2 * s.n_groups * s.d_state + heads),
                        ("embed", "mlp")),
        "conv_w": spec((s.d_conv, conv_dim), ("conv", "mlp"), init="fanin"),
        "conv_b": spec((conv_dim,), ("mlp",), init="zeros"),
        "a_log": spec((heads,), ("heads",), init="zeros"),
        "d_skip": spec((heads,), ("heads",), init="ones"),
        "dt_bias": spec((heads,), ("heads",), init="zeros"),
        "norm": spec((d_in,), ("mlp",), init="ones"),
        "out_proj": spec((d_in, d), ("mlp", "embed")),
    }


def _split(zxbcdt: torch.Tensor, cfg: ModelConfig):
    _, d_in, _, conv_dim = _dims(cfg)
    return (zxbcdt[..., :d_in], zxbcdt[..., d_in:d_in + conv_dim],
            zxbcdt[..., d_in + conv_dim:])


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """xbc (B,S,C), w (K,C): depthwise causal conv along S, then silu."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + s, :] * w[i] for i in range(k))
    return F.silu(out + b)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) at every x (``F.softplus``
    turns into the identity above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    y32 = (y * F.silu(z)).float()
    var = (y32 * y32).mean(-1, keepdim=True)
    return (y32 * torch.rsqrt(var + 1e-6) * scale.float()).to(y.dtype)


def _ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 bmat: torch.Tensor, cmat: torch.Tensor, chunk: int):
    """Minimal SSD. xh (B,S,H,P), dt (B,S,H), a (H,) negative, b/c (B,S,N).
    Returns y (B,S,H,P) and the final state (B,H,N,P)."""
    bsz, s, h, p = xh.shape
    n = bmat.shape[-1]
    q = min(chunk, s)
    while s % q:
        q //= 2
    nc = s // q
    xd = xh * dt[..., None]  # fold dt into the inputs
    la = dt * a  # (B,S,H) log-decay a step
    xd_c = xd.reshape(bsz, nc, q, h, p)
    b_c = bmat.reshape(bsz, nc, q, n)
    c_c = cmat.reshape(bsz, nc, q, n)
    cum = torch.cumsum(la.reshape(bsz, nc, q, h), dim=2)  # (B,nc,q,H)

    # intra-chunk: L[i,j] = exp(cum_i - cum_j) for i >= j, 0 above the
    # diagonal. The select comes before the exp (exp(-inf) = 0): JAX's
    # selects after it, where cum_i - cum_j overflows exp to inf, and its
    # backward then multiplies inf by the select's zero gradient into NaN
    # grads (ROADMAP queue 3, item 23). The values are the same.
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,i,j,H)
    mask = torch.ones((q, q), dtype=torch.bool, device=xh.device).tril()
    lmat = torch.exp(torch.where(mask[None, None, :, :, None], li,
                                 torch.full((), -torch.inf, dtype=li.dtype,
                                            device=li.device)))
    cb = torch.einsum("bcin,bcjn->bcij", c_c, b_c)
    y_diag = torch.einsum("bcij,bcijh,bcjhp->bcihp", cb, lmat, xd_c)

    # chunk states: S_c = sum_j exp(cum_last - cum_j) B_j xd_j^T
    decay_states = torch.exp(cum[:, :, -1:, :] - cum)  # (B,nc,q,H)
    states = torch.einsum("bcjn,bcjh,bcjhp->bchnp", b_c, decay_states, xd_c)

    # inter-chunk recurrence over the chunks (JAX's lax.scan)
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B,nc,H)
    hcur = torch.zeros((bsz, h, n, p), dtype=xh.dtype, device=xh.device)
    hprevs = []
    for c in range(nc):
        hprevs.append(hcur)
        hcur = hcur * chunk_decay[:, c, :, None, None] + states[:, c]
    hprev = torch.stack(hprevs, 1)  # (B,nc,H,N,P) state before each chunk

    # inter-chunk contribution: C_i . h_prev scaled by exp(cum_i)
    y_off = torch.einsum("bcin,bcih,bchnp->bcihp", c_c, torch.exp(cum), hprev)
    return (y_diag + y_off).reshape(bsz, s, h, p), hcur


def ssm_apply(params, x: torch.Tensor, cfg: ModelConfig, *,
              state: Optional[dict] = None):
    """Mamba-2 block.

    prefill: state=None -> (out, final_state), final_state = {"h": (B,H,N,P)
    fp32, "conv": (B,K-1,conv_dim) in the compute dtype}.
    decode: state given, x is (B,1,D) -> (out, new_state); ``h`` stays fp32
    and the new conv tail takes ``state["conv"]``'s dtype.
    """
    s, d_in, heads, conv_dim = _dims(cfg)
    dt_ = cfg.compute_dtype
    zxbcdt = x @ params["in_proj"].to(dt_)
    z, xbc_raw, dtp = _split(zxbcdt, cfg)
    a = -torch.exp(params["a_log"].float())  # (H,)
    bsz = x.shape[0]

    if state is None:
        seq = x.shape[1]
        xbc = _causal_conv(xbc_raw, params["conv_w"].to(dt_),
                           params["conv_b"].to(dt_))
        xin = xbc[..., :d_in]
        bmat = xbc[..., d_in:d_in + s.d_state].float()
        cmat = xbc[..., d_in + s.d_state:].float()
        dt = _softplus(dtp.float() + params["dt_bias"].float())
        xh = xin.reshape(bsz, seq, heads, s.head_dim).float()
        y, hfinal = _ssd_chunked(xh, dt, a, bmat, cmat, s.chunk)
        y = y + params["d_skip"].float()[None, None, :, None] * xh
        y = _gated_norm(y.reshape(bsz, seq, d_in).to(dt_), z, params["norm"])
        out = y @ params["out_proj"].to(dt_)
        k = s.d_conv
        conv_tail = (xbc_raw[:, -(k - 1):, :] if seq >= k - 1
                     else F.pad(xbc_raw, (0, 0, k - 1 - seq, 0)))
        return out, {"h": hfinal.float(), "conv": conv_tail}

    # ---- decode (one token)
    conv_prev = state["conv"]  # (B, K-1, conv_dim)
    window = torch.cat([conv_prev.to(dt_), xbc_raw], dim=1)  # (B,K,conv_dim)
    xbc = F.silu(torch.einsum("bkc,kc->bc", window, params["conv_w"].to(dt_))
                 + params["conv_b"].to(dt_))
    xin = xbc[:, :d_in]
    bmat = xbc[:, d_in:d_in + s.d_state].float()  # (B,N)
    cmat = xbc[:, d_in + s.d_state:].float()
    dt = _softplus(dtp[:, 0].float() + params["dt_bias"].float())  # (B,H)
    xh = xin.reshape(bsz, heads, s.head_dim).float()
    decay = torch.exp(dt * a[None, :])  # (B,H)
    h_new = (state["h"] * decay[:, :, None, None]
             + torch.einsum("bn,bh,bhp->bhnp", bmat, dt, xh))
    y = torch.einsum("bn,bhnp->bhp", cmat, h_new)
    y = y + params["d_skip"].float()[None, :, None] * xh
    y = _gated_norm(y.reshape(bsz, 1, d_in).to(dt_), z, params["norm"])
    out = y @ params["out_proj"].to(dt_)
    conv_new = torch.cat([conv_prev[:, 1:], xbc_raw.to(conv_prev.dtype)], dim=1)
    return out, {"h": h_new, "conv": conv_new}


def ssm_init_state(cfg: ModelConfig, batch: int, *, device="cuda"):
    """Zeroed decode state, fp32: ``h`` (B,H,N,P), ``conv`` (B,K-1,conv_dim)."""
    s, _, heads, conv_dim = _dims(cfg)
    dev = resolve_device(device)
    return {
        "h": torch.zeros((batch, heads, s.d_state, s.head_dim),
                         dtype=torch.float32, device=dev),
        "conv": torch.zeros((batch, s.d_conv - 1, conv_dim),
                            dtype=torch.float32, device=dev),
    }
