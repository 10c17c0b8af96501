"""A plain DeepSeek-V2 forward in PyTorch, for the ``lm`` family's
comparison: fp32 (TF32 off), or every matrix product's operands rounded
to fp8 e4m3 (the control). It imports nothing of the program.

It follows the published model (arXiv:2405.04434; the keys of its
``config.json``, which the configuration file copies):

- RMSNorm (``rms_norm_eps``) before attention and before the MLP, and
  before the output head;
- MLA without a query LoRA: per head, q = x W_q (``qk_nope_head_dim`` +
  ``qk_rope_head_dim``); the latent c = RMSNorm(x W_dkv) (``kv_lora_rank``)
  and one rotary key k_pe = x W_kpe shared by the heads; keys [c W_uk,
  k_pe] and values c W_uv, expanded; causal softmax attention at the
  scale (nope + rope)^-1/2 times YaRN's mscale squared;
- YaRN on the rotary dims (DeepSeek's ``DeepseekV2YarnRotaryEmbedding``:
  frequencies blended between theta^(-2i/d) and that over ``factor`` by
  a linear ramp between the correction dims of ``beta_fast`` and
  ``beta_slow``, cos and sin scaled by the two mscales' ratio). The
  rotary pairs are the half split (i, i + d/2), the program's: DeepSeek's
  interleaved pairs are the same model under a fixed permutation of the
  rotary columns of W_q and W_kpe;
- ``first_k_dense_replace`` layers with a SwiGLU of ``intermediate_size``;
  then MoE: softmax over ``n_routed_experts``, the top
  ``num_experts_per_tok`` (ties to the lower index), their probabilities
  as the gates, renormalised only under ``norm_topk_prob``, times
  ``routed_scaling_factor``; each selected expert's SwiGLU computed on
  the tokens routed to it; plus ``n_shared_experts`` experts as one
  SwiGLU of their summed width on every token;
- an untied output head.

Weights are a dict by path (tuples), stacked over a block's layers:
``("dense", ...)`` for the dense leading layers, ``("layers", ...)`` for
the MoE ones (see ``families/lm.py::leaf_shapes``). ``Forward`` runs a
set of sequences layer by layer, each layer's weights cast to fp32 once,
so that a whole model held in bf16 and one layer in fp32 fit one card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

PRECISIONS = ("fp32", "fp8")


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to fp8 e4m3 under a per-tensor scale (its largest
    magnitude at e4m3's largest, 448), back in fp32."""
    scale = t.abs().amax().clamp_min(1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        a, b = fp8(a), fp8(b)
    return a @ b


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def swiglu(x, w_gate, w_up, w_down, precision):
    return mm(F.silu(mm(x, w_gate, precision)) * mm(x, w_up, precision), w_down,
              precision)


def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def rope_tables(cfg: dict, positions: torch.Tensor):
    """(cos, sin), each (S, d/2), of the rotary dims at ``positions``."""
    d, theta = int(cfg["qk_rope_head_dim"]), float(cfg["rope_theta"])
    i = torch.arange(d // 2, dtype=torch.float32, device=positions.device)
    freqs = theta ** (-2.0 * i / d)
    scale = 1.0
    rs = cfg.get("rope_scaling")
    if rs:
        factor, orig = float(rs["factor"]), float(rs["original_max_position_embeddings"])

        def corr(rotations):
            return d * math.log(orig / (rotations * 2 * math.pi)) / (2 * math.log(theta))

        low = max(math.floor(corr(rs["beta_fast"])), 0)
        high = min(math.ceil(corr(rs["beta_slow"])), d - 1)
        keep = 1.0 - ((i - low) / max(high - low, 1e-3)).clamp(0.0, 1.0)
        freqs = freqs / factor * (1.0 - keep) + freqs * keep
        scale = (yarn_mscale(factor, rs.get("mscale", 1.0))
                 / yarn_mscale(factor, rs.get("mscale_all_dim", 0.0)))
    ang = positions.float()[:, None] * freqs
    return ang.cos() * scale, ang.sin() * scale


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (S, H, d) with each half pair (i, i + d/2) rotated."""
    half = x.shape[-1] // 2
    c, s = cos[:, None], sin[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1)


def softmax_scale(cfg: dict) -> float:
    scale = (int(cfg["qk_nope_head_dim"]) + int(cfg["qk_rope_head_dim"])) ** -0.5
    rs = cfg.get("rope_scaling")
    if rs and rs.get("mscale_all_dim"):
        scale *= yarn_mscale(float(rs["factor"]), float(rs["mscale_all_dim"])) ** 2
    return scale


def attention(cfg: dict, w: dict, x: torch.Tensor, precision: str) -> torch.Tensor:
    """MLA, expanded, over one sequence x (S, D) of normed inputs."""
    s = x.shape[0]
    h, nope = int(cfg["num_attention_heads"]), int(cfg["qk_nope_head_dim"])
    rope, dv = int(cfg["qk_rope_head_dim"]), int(cfg["v_head_dim"])
    lora, eps = int(cfg["kv_lora_rank"]), float(cfg["rms_norm_eps"])
    d = x.shape[1]
    cos, sin = rope_tables(cfg, torch.arange(s, device=x.device))
    q = mm(x, w["wq"].reshape(d, -1), precision).reshape(s, h, nope + rope)
    c = rms(mm(x, w["w_dkv"], precision), w["kv_norm"], eps)
    k_pe = rotate(mm(x, w["w_kpe"], precision)[:, None], cos, sin)
    k_nope = mm(c, w["w_uk"].reshape(lora, -1), precision).reshape(s, h, nope)
    v = mm(c, w["w_uv"].reshape(lora, -1), precision).reshape(s, h, dv)
    q = torch.cat([q[..., :nope], rotate(q[..., nope:], cos, sin)], -1)
    k = torch.cat([k_nope, k_pe.expand(s, h, rope)], -1)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    score = mm(q.transpose(0, 1), k.permute(1, 2, 0), precision) * softmax_scale(cfg)
    p = torch.softmax(score.masked_fill(~causal, -math.inf), -1)  # (H, S, S)
    ctx = mm(p, v.transpose(0, 1), precision).transpose(0, 1)  # (S, H, dv)
    return mm(ctx.reshape(s, h * dv), w["wo"].reshape(h * dv, d), precision)


def moe(cfg: dict, w: dict, x: torch.Tensor, precision: str) -> torch.Tensor:
    """The routed experts, each on the tokens it was chosen for, plus the
    shared experts, over x (T, D) of normed inputs."""
    k = int(cfg["num_experts_per_tok"])
    probs = torch.softmax(x @ w["router"], -1)  # the router runs in fp32
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, sel = order.values[:, :k], order.indices[:, :k]
    if cfg["norm_topk_prob"]:
        gates = gates / gates.sum(-1, keepdim=True)
    gates = gates * float(cfg["routed_scaling_factor"])
    out = swiglu(x, w["shared"]["wi_gate"], w["shared"]["wi_up"], w["shared"]["wo"],
                 precision)
    for e in range(int(cfg["n_routed_experts"])):
        tok, slot = (sel == e).nonzero(as_tuple=True)
        if tok.numel():
            y = swiglu(x[tok], w["w_gate"][e], w["w_up"][e], w["w_down"][e], precision)
            out.index_add_(0, tok, y * gates[tok, slot, None])
    return out


def _layer_weights(weights: dict, block: str, i: int) -> dict:
    """Layer ``i`` of ``block`` as a nested dict of fp32 tensors."""
    out: dict = {}
    for path, leaf in weights.items():
        if path[0] != block:
            continue
        node = out
        for key in path[1:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf[i].float()
    return out


class Forward:
    """The final normed hidden states of a set of sequences, computed
    layer by layer: ``run({key: (tokens (S,), first)})`` keeps, for each
    sequence, its rows from position ``first`` on; ``logits(h)`` maps such
    rows through the output head."""

    def __init__(self, cfg: dict, weights: dict, precision: str = "fp32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}: {precision!r}")
        self.cfg, self.w, self.precision = cfg, weights, precision
        self._head = None

    def run(self, seqs: dict) -> dict:
        cfg, w, p = self.cfg, self.w, self.precision
        eps = float(cfg["rms_norm_eps"])
        tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            with torch.inference_mode():
                keys = list(seqs)
                lengths = [len(seqs[key][0]) for key in keys]
                tokens = torch.cat([seqs[key][0].long() for key in keys])
                x = w[("embed", "tokens")][tokens].float()
                bounds = [0]
                for n in lengths:
                    bounds.append(bounds[-1] + n)
                n_dense = int(cfg["first_k_dense_replace"])
                for layer in range(int(cfg["num_hidden_layers"])):
                    block, i = (("dense", layer) if layer < n_dense
                                else ("layers", layer - n_dense))
                    lw = _layer_weights(w, block, i)
                    h = rms(x, lw["ln1"]["scale"], eps)
                    x = x + torch.cat([attention(cfg, lw["mix"], h[a:b], p)
                                       for a, b in zip(bounds, bounds[1:])])
                    h = rms(x, lw["ln2"]["scale"], eps)
                    m = lw["mlp"]
                    x = x + (swiglu(h, m["wi_gate"], m["wi_up"], m["wo"], p)
                             if block == "dense" else moe(cfg, m, h, p))
                    del lw, h
                final = w[("final_norm", "scale")].float()
                return {key: rms(x[a + seqs[key][1]:b], final, eps)
                        for key, a, b in zip(keys, bounds, bounds[1:])}
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        if self._head is None:
            self._head = self.w[("embed", "unembed")].float()
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            with torch.inference_mode():
                return mm(h, self._head, self.precision)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
