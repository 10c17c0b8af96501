"""Frozen shape arithmetic of the ViG configurations: the stage plans
(grids, co-nodes, per-block k and dilation), the work of each DIGC and
MRConv call, the model's FLOPs per image, and the H100's peaks.

The plans follow the dilation rule the configuration files state: block
``g`` (counted over the whole model) dilates by ``min(g // 4 + 1,
max_dilation)``, lowered while ``k * d`` exceeds the stage's co-nodes M;
k is clamped to ``M // d``. Only native grids are planned.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W limit.
PEAK_TF32_FLOPS = 495e12  # tensor cores: the fastest fp32-accurate path
PEAK_FP32_FLOPS = 67e12   # CUDA cores, outside the tensor cores
PEAK_HBM_BYTES = 3.35e12
F32 = 4
I32 = 4


def block_geometry(cfg: dict, global_block: int, m: int) -> tuple[int, int]:
    """(dilation, k) of one Grapher block against ``m`` co-nodes."""
    k = int(cfg["k"])
    d = 1
    if cfg["use_dilation"]:
        d = min(global_block // 4 + 1, int(cfg["max_dilation"]))
        while k * d > m and d > 1:
            d -= 1
    k_eff = min(k, m // max(d, 1)) or 1
    if k_eff * d > m:
        d = 1
    return d, k_eff


def stage_plans(cfg: dict) -> list[dict]:
    """One dict per stage: grid, n (nodes), r, m (co-nodes), dim and the
    per-block ``(dilation, k)`` list."""
    grid = int(cfg["image_size"]) // int(cfg["patch"])
    plans, gb = [], 0
    depths, ratios = cfg["depths"], cfg["reduce_ratios"]
    for si, depth in enumerate(depths):
        r = int(ratios[si]) if si < len(ratios) else 1
        m = (grid // max(r, 1)) ** 2
        blocks = [block_geometry(cfg, gb + bi, m) for bi in range(depth)]
        plans.append({"stage": si, "grid": grid, "n": grid * grid, "r": r,
                      "m": m, "dim": int(cfg["embed_dims"][si]),
                      "blocks": blocks})
        gb += depth
        if si + 1 < len(depths):
            grid //= 2
    return plans


def digc_calls(cfg: dict, batch: int) -> list[dict]:
    """The DIGC calls of one forward of ``batch`` images: (b, n, m, d, kd)
    with kd = k * dilation, the sorted list the kernel returns."""
    return [{"b": batch, "n": p["n"], "m": p["m"], "d": p["dim"],
             "kd": k * dil}
            for p in stage_plans(cfg) for dil, k in p["blocks"]]


def mrconv_calls(cfg: dict, batch: int) -> list[dict]:
    """The MRConv calls of one forward: (b, n, m, d, k) after dilation."""
    return [{"b": batch, "n": p["n"], "m": p["m"], "d": p["dim"], "k": k}
            for p in stage_plans(cfg) for _, k in p["blocks"]]


def digc_least_s(c: dict) -> float:
    """The least time of one DIGC call: 2 b n m d distance products on
    the tensor cores, or x and y read once and the sorted (index,
    distance) lists written once, whichever takes longer."""
    flops = 2.0 * c["b"] * c["n"] * c["m"] * c["d"]
    nbytes = (F32 * c["b"] * (c["n"] + c["m"]) * c["d"]
              + (I32 + F32) * c["b"] * c["n"] * c["kd"])
    return max(flops / PEAK_TF32_FLOPS, nbytes / PEAK_HBM_BYTES)


def mrconv_least_s(c: dict) -> float:
    """The least time of one MRConv call: a subtract and a max per
    (node, neighbour, feature) on the CUDA cores, or x, y and the
    indices read once and the aggregate written once."""
    flops = 2.0 * c["b"] * c["n"] * c["k"] * c["d"]
    nbytes = (F32 * c["b"] * (2 * c["n"] + c["m"]) * c["d"]
              + I32 * c["b"] * c["n"] * c["k"])
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES)


def model_flops_per_image(cfg: dict) -> float:
    """Every GEMM of one image's forward (stem, the Grapher's fc_in,
    fc_graph and fc_out, the FFN, the downsamples, the head) plus DIGC's
    distance products."""
    plans = stage_plans(cfg)
    p0 = plans[0]
    chans = int(cfg["in_chans"]) * int(cfg["patch"]) ** 2
    total = 2.0 * p0["n"] * chans * p0["dim"]
    ffn = int(cfg["ffn_ratio"])
    for i, p in enumerate(plans):
        n, m, d = p["n"], p["m"], p["dim"]
        per_block = 2.0 * n * d * d * (1 + 2 + 1 + 2 * ffn) + 2.0 * n * m * d
        total += per_block * len(p["blocks"])
        if i + 1 < len(plans):
            total += 2.0 * (n // 4) * 4 * d * plans[i + 1]["dim"]
    total += 2.0 * plans[-1]["dim"] * int(cfg["num_classes"])
    return total
