"""A plain PyTorch ViG forward, written from the configuration files and
the published equations (Han et al., "Vision GNN", NeurIPS 2022), with
no kernel, batching trick or cache of the program under test.

Per image: patchify (row-major patches, features ordered (row, column,
channel)) -> linear stem + positional embedding -> per stage, Grapher
blocks -> 2x2 patch merge between stages (features ordered (row offset,
column offset, feature)) -> mean over nodes -> linear head. A Grapher
block:

    h   = LN(x) W_in
    y   = h, or h average-pooled over r x r cells (co-nodes) when r > 1
    D   = ||h_i||^2 - 2 h_i . y_j + ||y_j||^2          (Algorithm 1)
    I_i = every d-th entry of the k*d nearest y_j, nearest first,
          the lower index first among equal distances
    a_i = max_{j in I_i} (y_j - h_i)                    (max-relative)
    x   = x + GELU([h ; a] W_graph) W_out
    x   = x + GELU(LN(x) W_1) W_2

LN has a scale and no bias, population variance and eps 1e-6; GELU is
the tanh form. ``precision="tf32"`` rounds every matrix product's
operands to TF32 (10 mantissa bits, to nearest) and accumulates in fp32:
the control that the comparison must fail.
"""

from __future__ import annotations

import math

import torch

from vigbench import shapes

LN_EPS = 1e-6


def _tf32(t: torch.Tensor) -> torch.Tensor:
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        a, b = _tf32(a), _tf32(b)
    elif precision != "fp32":
        raise ValueError(f"precision must be fp32 or tf32, got {precision!r}")
    return a @ b


def _ln(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * scale


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x.pow(3))))


def neighbours(h: torch.Tensor, y: torch.Tensor, k: int, dilation: int,
               precision: str) -> torch.Tensor:
    """(B, N, D) nodes, (B, M, D) co-nodes -> (B, N, k) int64 indices."""
    inner = _mm(h, y.transpose(1, 2), precision)
    dist = (h * h).sum(-1, keepdim=True) - 2.0 * inner + (y * y).sum(-1)[:, None, :]
    order = torch.sort(dist, dim=-1, stable=True).indices
    return order[..., : k * dilation : dilation]


def grapher(bw: dict, x: torch.Tensor, grid: int, r: int, k: int,
            dilation: int, precision: str) -> torch.Tensor:
    """One Grapher block and its FFN."""
    b, n, d = x.shape
    h = _mm(_ln(x, bw["ln_g/scale"]), bw["fc_in"], precision)
    if r > 1:
        g = grid // r
        y = h.reshape(b, g, r, g, r, d).mean(dim=(2, 4)).reshape(b, g * g, d)
    else:
        y = h
    idx = neighbours(h, y, k, dilation, precision)
    rows = torch.arange(b, device=x.device)[:, None, None]
    agg = (y[rows, idx] - h[:, :, None, :]).amax(dim=2)
    g_out = _mm(_gelu(_mm(torch.cat([h, agg], -1), bw["fc_graph"], precision)),
                bw["fc_out"], precision)
    x = x + g_out
    f = _gelu(_mm(_ln(x, bw["ln_f/scale"]), bw["fc1"], precision))
    return x + _mm(f, bw["fc2"], precision)


def forward(weights: dict, images: torch.Tensor, cfg: dict, *,
            precision: str = "fp32") -> torch.Tensor:
    """images (B, H, W, C) -> logits (B, num_classes), in fp32.
    ``weights`` maps the configuration's parameter paths to tensors."""
    if cfg["norm"] != "layernorm_scale_eps1e-6" or cfg["act"] != "gelu_tanh":
        raise ValueError("the reference knows layernorm_scale_eps1e-6 and "
                         f"gelu_tanh only; got {cfg['norm']}, {cfg['act']}")
    images = images.float()
    b, hh, ww, c = images.shape
    p = int(cfg["patch"])
    gh, gw = hh // p, ww // p
    x = images.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
    x = _mm(x.reshape(b, gh * gw, p * p * c), weights["stem"], precision)
    x = x + weights["pos"]
    plans = shapes.stage_plans(cfg)
    for plan in plans:
        si = plan["stage"]
        for bi, (dil, k) in enumerate(plan["blocks"]):
            bw = {name[len(f"stage{si}/block{bi}/"):]: t
                  for name, t in weights.items()
                  if name.startswith(f"stage{si}/block{bi}/")}
            x = grapher(bw, x, plan["grid"], plan["r"], k, dil, precision)
        if si + 1 < len(plans):
            g2, d = plan["grid"] // 2, x.shape[-1]
            x = x.reshape(b, g2, 2, g2, 2, d).permute(0, 1, 3, 2, 4, 5)
            x = _mm(x.reshape(b, g2 * g2, 4 * d), weights[f"down{si}"], precision)
    return _mm(x.mean(dim=1), weights["head"], precision)
