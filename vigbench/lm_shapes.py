"""Frozen shape arithmetic of the LM configurations (the keys of a
DeepSeek-V2 ``config.json``): the parameters by part, the model FLOPs of
a served token, the bytes a decode step needs, and the H100's peaks.

Work is counted as the model's own routed work, whatever the program
computes: each token runs its ``num_experts_per_tok`` experts (the
program's dense MoE runs all of them), and attends the cache positions
before it, its own included, with the expanded heads' widths
(qk = nope + rope, v). A matrix product of m x n weights costs 2 m n
FLOPs a token; the input embedding is a lookup and costs none.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12  # H100 SXM data sheet, dense, at the full 700 W
PEAK_HBM_BYTES = 3.35e12
BF16 = 2
F32 = 4


def parts(cfg: dict) -> dict[str, int]:
    """Parameter counts: ``embed`` (the input lookup), ``head``,
    ``attention`` and ``norms`` (all layers), ``dense_mlp``,
    ``shared`` and ``router`` (all layers), ``expert`` (one routed
    expert of one layer), and ``moe_layers``."""
    d, v = int(cfg["hidden_size"]), int(cfg["vocab_size"])
    h, nope = int(cfg["num_attention_heads"]), int(cfg["qk_nope_head_dim"])
    rope, dv = int(cfg["qk_rope_head_dim"]), int(cfg["v_head_dim"])
    lora, layers = int(cfg["kv_lora_rank"]), int(cfg["num_hidden_layers"])
    n_dense = int(cfg["first_k_dense_replace"])
    moe_layers = layers - n_dense
    f = int(cfg["moe_intermediate_size"])
    attention = (d * h * (nope + rope) + d * lora + d * rope + lora * h * (nope + dv)
                 + h * dv * d)
    return {
        "embed": v * d,
        "head": d * v,
        "attention": layers * attention,
        "norms": layers * (2 * d + lora) + d,
        "dense_mlp": n_dense * 3 * d * int(cfg["intermediate_size"]),
        "shared": moe_layers * 3 * d * f * int(cfg["n_shared_experts"]),
        "router": moe_layers * d * int(cfg["n_routed_experts"]),
        "expert": 3 * d * f,
        "moe_layers": moe_layers,
    }


def parameters(cfg: dict) -> int:
    """Every parameter of the model."""
    p = parts(cfg)
    experts = p["moe_layers"] * int(cfg["n_routed_experts"]) * p["expert"]
    return sum(p[k] for k in ("embed", "head", "attention", "norms", "dense_mlp",
                              "shared", "router")) + experts


def active_matmul_parameters(cfg: dict) -> int:
    """The weights of the matrix products one token runs: all but the
    input embedding, the norms and the experts it does not select."""
    p = parts(cfg)
    routed = p["moe_layers"] * int(cfg["num_experts_per_tok"]) * p["expert"]
    return (p["head"] + p["attention"] + p["dense_mlp"] + p["shared"] + p["router"]
            + routed)


def attention_flops_per_position(cfg: dict) -> int:
    """One token's attention FLOPs for each cache position it attends,
    over all layers: scores (qk wide) and the weighted values (v wide)."""
    h = int(cfg["num_attention_heads"])
    qk = int(cfg["qk_nope_head_dim"]) + int(cfg["qk_rope_head_dim"])
    return 2 * h * (qk + int(cfg["v_head_dim"])) * int(cfg["num_hidden_layers"])


def prefill_flops(cfg: dict, tokens: int) -> float:
    """A prompt of ``tokens``: each position's products, and its causal
    attention over positions 1 .. S."""
    return (2.0 * active_matmul_parameters(cfg) * tokens
            + attention_flops_per_position(cfg) * tokens * (tokens + 1) / 2)


def decode_flops(cfg: dict, rows: int, kv: int) -> float:
    """One decode step of ``rows`` tokens attending ``kv`` positions in
    all (their new ones included)."""
    return (2.0 * active_matmul_parameters(cfg) * rows
            + attention_flops_per_position(cfg) * kv)


def experts_selected(cfg: dict, rows: int) -> float:
    """The routed experts a layer's ``rows`` tokens select, expected
    under uniform routing: E (1 - (1 - k / E)^rows)."""
    e, k = int(cfg["n_routed_experts"]), int(cfg["num_experts_per_tok"])
    return e * (1.0 - (1.0 - k / e) ** rows)


def decode_bytes(cfg: dict, rows: int, kv: int) -> float:
    """The bytes a decode step of ``rows`` tokens attending ``kv``
    positions must move: every weight outside the experts once (bf16; the
    router and norms fp32), the selected experts' weights once in each
    MoE layer, the ``rows`` embedding rows, and the ``kv`` latent and
    rotary cache rows of every layer (bf16)."""
    p = parts(cfg)
    d = int(cfg["hidden_size"])
    weights = BF16 * (p["head"] + p["attention"] + p["dense_mlp"] + p["shared"])
    weights += F32 * (p["router"] + p["norms"])
    experts = BF16 * p["moe_layers"] * experts_selected(cfg, rows) * p["expert"]
    cache_row = BF16 * (int(cfg["kv_lora_rank"]) + int(cfg["qk_rope_head_dim"]))
    return (weights + experts + BF16 * rows * d
            + cache_row * kv * int(cfg["num_hidden_layers"]))
