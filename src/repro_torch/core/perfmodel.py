"""The paper's analytical performance model (Table I) and a Hopper cost
model for the port (counterpart of ``repro/core/perfmodel.py``).

Paper cycle model (per ViG layer DIGC):
    DCM: ceil(N/P_row) * ceil(M/P_col) * ceil(D/P_vec)
    LSM: ceil(N/P_sort) * (m * ceil(log2 m))
    GMM: N * k * ceil(log2 Q)
    NSM: ceil(N/Q) * k
Reference config (ViG-Tiny): N=M=196, D=192, k=8, d=2, m=28,
P_row=P_col=14, P_vec=8, P_sort=7, Q=7 -> Table I reports
DCM=4704, LSM=3920, GMM=4704, NSM=224.

The Hopper model estimates the same quantities for the CUDA kernel
(``kernels/csrc/digc_topk.cu``) at an H100's data-sheet rates: the
product on the tensor cores (three TF32 products per fp32 product, or
one bf16 product), the bytes the kernel must move, and the integer lane
work of its merge. The tuner ranks candidates with it
before it measures them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def clog2(v: int) -> int:
    return max(1, math.ceil(math.log2(max(v, 2))))


@dataclass(frozen=True)
class FPGAConfig:
    """Static parallelism of the paper's accelerator."""

    p_row: int = 14
    p_col: int = 14
    p_vec: int = 8
    p_sort: int = 7
    q: int = 7
    m_part: int = 28  # partition size m


def fpga_cycles(n: int, m: int, d: int, k: int, cfg: FPGAConfig = FPGAConfig()):
    """Paper Table I formulas, verbatim."""
    dcm = ceil_div(n, cfg.p_row) * ceil_div(m, cfg.p_col) * ceil_div(d, cfg.p_vec)
    lsm = ceil_div(n, cfg.p_sort) * (cfg.m_part * clog2(cfg.m_part))
    gmm = n * k * clog2(cfg.q)
    nsm = ceil_div(n, cfg.q) * k
    return {"DCM": dcm, "LSM": lsm, "GMM": gmm, "NSM": nsm}


def fpga_latency_ms(n: int, m: int, d: int, k: int, clock_hz: float = 600e6,
                    cfg: FPGAConfig = FPGAConfig()) -> float:
    """Pipeline latency estimate: modules are deeply pipelined, so total
    time ~ max stage (streaming) + fill; the sum is the conservative
    serial bound (the paper's per-module table)."""
    cyc = fpga_cycles(n, m, d, k, cfg)
    return sum(cyc.values()) / clock_hz * 1e3


@dataclass(frozen=True)
class H100Config:
    """One NVIDIA H100 SXM (data sheet and Hopper white paper)."""

    peak_fp32_flops: float = 67e12  # CUDA cores, no tensor cores
    peak_tf32_flops: float = 495e12  # tensor cores, dense
    peak_bf16_flops: float = 989e12  # tensor cores, dense
    hbm_bw: float = 3.35e12  # bytes/s
    sms: int = 132
    int32_lanes_per_sm: int = 64  # int32 operations per SM per cycle
    clock_hz: float = 1.98e9  # boost clock
    smem_per_sm: int = 233472  # 228 KB, of which a block may use 227 KB
    smem_per_block: int = 232448

    @property
    def lane_ops(self) -> float:
        """int32 lane operations per second: the merge's rate."""
        return self.sms * self.int32_lanes_per_sm * self.clock_hz


# The CUDA DIGC kernel's geometry (csrc/digc_topk.cu). A block owns BN
# query rows and walks co-node chunks of CHUNK columns; y streams through
# a shared-memory ring of RING pieces of CHUNK columns x PIECE_D
# features (half that in 8-warp blocks), x stays staged, X_SLAB features
# at a time. A block has 16
# warps (one block a SM) where the grid fits on the SMs, else 8 (two a
# SM); warp w multiplies the tile's 16 x 8 slice w % 8 (with 16 warps,
# over every other MMA step, the halves' sums meeting in shared memory).
# The lists and the legacy buffers get what is left of the SM's shared
# memory beside one 16-warp block.
CUDA_BLOCK_N = 16
CUDA_CHUNK_M = 64
CUDA_PIECE_D = 128  # 16-warp blocks; 64 for 8-warp blocks
CUDA_X_SLAB = 256
CUDA_RING = 3
CUDA_WARPS = 16
CUDA_BLOCKS_PER_SM = 1
CUDA_MAX_KD = 256
CUDA_MAX_BUFFER = 512


def cuda_static_smem(legacy: bool) -> int:
    """Shared memory of one block beside its lists, at most (over D, both
    operand types and both block sizes): the y ring (rows of PIECE_D + 16
    floats, the bf16 stride), x at its widest slab (a (hi, lo) pair per
    feature plus 16 floats a row), the distance tile (rows of CHUNK + 8
    floats) and the row norms, the hand-over between the two halves of
    the warps (8 slices x 5 x 32 floats); the bitonic merge adds its
    64-key sort scratch per warp, the legacy merge a candidate count per
    row."""
    ring = CUDA_RING * CUDA_CHUNK_M * (CUDA_PIECE_D + 16) * 4
    x = CUDA_BLOCK_N * (2 * CUDA_X_SLAB + 16) * 4
    tile = CUDA_BLOCK_N * (CUDA_CHUNK_M + 8 + 1) * 4
    partials = 8 * 5 * 32 * 4
    merge = CUDA_BLOCK_N * 4 if legacy else CUDA_WARPS * CUDA_CHUNK_M * 8
    return ring + x + tile + partials + merge


def cuda_dynamic_smem(kd: int, buffer: int, key_bytes: int,
                      legacy: bool) -> int:
    """Dynamic shared memory of one block: BN rows of (kd + buffer) keys
    and, for the legacy merge, one kd-key list per warp."""
    outs = CUDA_WARPS * kd if legacy else 0
    return (CUDA_BLOCK_N * (kd + buffer) + outs) * key_bytes


def cuda_merge_buffer(kd: int, key_bytes: int = 8,
                      cfg: H100Config = H100Config()) -> int:
    """Candidates a row can buffer between merges: the largest multiple
    of CHUNK (at most CUDA_MAX_BUFFER) that keeps a legacy block within
    its share of the SM's shared memory at CUDA_BLOCKS_PER_SM blocks."""
    budget = cfg.smem_per_sm // CUDA_BLOCKS_PER_SM - cuda_static_smem(True)
    room = budget // key_bytes - (CUDA_BLOCK_N + CUDA_WARPS) * kd
    buf = (room // CUDA_BLOCK_N) // CUDA_CHUNK_M * CUDA_CHUNK_M
    return max(CUDA_CHUNK_M, min(CUDA_MAX_BUFFER, buf))


def digc_flops(n: int, m: int, d: int) -> int:
    """FLOPs for the distance computation (the product term dominates)."""
    return 2 * n * m * d  # -2XY^T matmul; norm terms are O(ND + MD)


def digc_hbm_bytes(n: int, m: int, d: int, kd: int, *, block_n: int,
                   streaming: bool, with_pos_bias: bool = False,
                   dtype_bytes: int = 4) -> int:
    """External-memory traffic. The paper's central claim: streaming keeps
    traffic at O(ND + MD + N*kd) while the naive path writes + re-reads
    the N*M distance matrix."""
    x_bytes = n * d * dtype_bytes
    # Y is re-read once per node-block sweep (same as a blocked matmul).
    y_sweeps = ceil_div(n, block_n) if streaming else 1
    y_bytes = m * d * dtype_bytes * y_sweeps
    out_bytes = n * kd * (4 + 4)
    p_bytes = n * m * dtype_bytes if with_pos_bias else 0
    traffic = x_bytes + y_bytes + out_bytes + p_bytes
    if not streaming:
        traffic += 2 * n * m * dtype_bytes  # write + read back D_XY for sort
        traffic += 2 * n * m * (4 + 4)  # sort (dist, idx) pairs through memory
    return traffic


def h100_digc_estimate(n: int, m: int, d: int, k: int, dilation: int,
                       block_n: int = CUDA_BLOCK_N, block_m: int = CUDA_CHUNK_M,
                       cfg: H100Config = H100Config(), *,
                       packed: bool = False, bucket_rounds: int = 0,
                       kernel_merge: str = "bitonic",
                       mxu_bf16: bool = False) -> dict:
    """Roofline-style estimate of one image's CUDA DIGC kernel.

    * compute: the product on the tensor cores, as the kernel takes it:
      three TF32 products (split TF32) per fp32 product at the TF32 rate,
      or one bf16 product at the bf16 rate with ``mxu_bf16``.
    * memory: x once, y once per row block, the (dist, idx) outputs.
    * merge, in int32 lane operations (one compare, select or shuffle is
      one operation per lane, ~3 per key visited):
      - ``bitonic``: per row and merge round of 64 buffered candidates,
        a 64-key warp bitonic sort (21 stages over 64 keys) and a rank
        merge (binary searches both ways);
      - ``legacy``: per row and logical tile of ``block_m`` columns, kd
        extraction passes over the list and the tile's candidates, each
        ending in a 5-step warp reduction;
      - ``bucket_rounds`` r: each column inserted into its bucket's
        r-entry list, then kd passes over kd + kd * r survivors.
      Packed keys halve the compare cost of the exact 64-bit key.
    """
    kd = k * dilation
    flops = digc_flops(n, m, d)
    compute_s = (flops / cfg.peak_bf16_flops if mxu_bf16
                 else 3 * flops / cfg.peak_tf32_flops)
    bytes_moved = digc_hbm_bytes(n, m, d, kd, block_n=block_n, streaming=True)
    memory_s = bytes_moved / cfg.hbm_bw
    key_ops = 3 if packed else 6
    tiles = ceil_div(m, block_m)
    m_pad = tiles * block_m
    if kernel_merge == "bitonic":
        rounds = ceil_div(m, CUDA_CHUNK_M)
        sort = 21 * CUDA_CHUNK_M
        rank = kd * clog2(CUDA_CHUNK_M) + CUDA_CHUNK_M * clog2(kd)
        lane_ops = n * rounds * (sort + rank + CUDA_CHUNK_M) * key_ops
    elif bucket_rounds > 0:
        sweep = n * m_pad * (bucket_rounds + 2) * key_ops
        passes = n * tiles * kd * ((kd + bucket_rounds * kd) + 32 * 5)
        lane_ops = sweep + passes * key_ops
    else:
        passes = n * tiles * kd * ((kd + min(block_m, m)) + 32 * 5)
        lane_ops = passes * key_ops
    merge_s = lane_ops / cfg.lane_ops
    naive_bytes = digc_hbm_bytes(n, m, d, kd, block_n=block_n, streaming=False)
    terms = [("compute", compute_s), ("memory", memory_s), ("merge", merge_s)]
    return {
        "flops": flops,
        "compute_s": compute_s,
        "hbm_bytes": bytes_moved,
        "memory_s": memory_s,
        "merge_s": merge_s,
        "bound": max(terms, key=lambda t: t[1])[0],
        "latency_s": max(compute_s, memory_s, merge_s),
        "naive_hbm_bytes": naive_bytes,
        "traffic_saving": naive_bytes / bytes_moved,
    }


def vig_resolution_to_nodes(resolution: int, patch: int = 16, reduction: int = 1) -> int:
    side = resolution // patch
    n = side * side
    return n // (reduction * reduction)


def kernel_tile_defaults(n: int, m: int, d: int, kd: int) -> tuple[int, int]:
    """Default (block_n, block_m) of the CUDA DIGC kernel: its row tile
    and one staged chunk. The 256 threads of a block hold 16 rows x 64
    columns of products, four in registers each, and a warp sorts one
    chunk's 64 candidates at two keys a lane, so the bitonic merge runs
    on every chunk (the legacy merge's block_m is free; its buffer is
    ``cuda_merge_buffer``). ``n``, ``m``, ``d`` and ``kd`` do not enter:
    D streams through the staged chunks, N through the grid, M through
    the block's loop, and kd lives in shared memory."""
    del n, m, d, kd
    return CUDA_BLOCK_N, CUDA_CHUNK_M


def pallas_tile_defaults(n: int, m: int, d: int, kd: int,
                         vmem_bytes: int = 128 * 1024 * 1024) -> tuple[int, int]:
    """The JAX package's VMEM-budgeted (block_n, block_m) for its Pallas
    kernel, kept because ``bucket_rounds`` results depend on block_m: a
    spec with ``bucket_rounds`` and no block_m takes this block_m, so the
    two packages cut the same buckets."""
    budget = vmem_bytes // 8  # double-buffered pipeline, headroom
    best = (128, 256)
    best_score = -1.0
    for bn in (128, 256, 512):
        if bn > max(ceil_div(n, 8) * 8, 8):
            continue
        for bm in (256, 512, 1024, 2048):
            if bm > ceil_div(m, 128) * 128:
                continue
            work = (bn * d + bm * d + bn * bm + 2 * bn * kd) * 4
            if work > budget:
                continue
            score = bm * 2 + bn  # wider co-node tiles first
            if score > best_score:
                best, best_score = (bn, bm), score
    return best


# ---------------------------------------------------------------------------
# Streaming-engine cost model (tuner priors)

# Per-backend throughput constants (seconds per unit). They only *rank*
# tile configurations before measurement refines them (core/tuner.py).
# "cpu": the JAX package's constants, fitted to its measured CPU
# decomposition (gemm ~40 GFLOP/s, top_k ~9 ns per candidate
# row-element, fused elementwise lane ~1 ns, tile materialization
# ~0.15 ns/byte, ~50 us dispatch per tile).
# "cuda": the blocked tier is eager PyTorch, and its calls on the card
# are paced by the host's launches, one round per tile: only the per-tile
# term is determined by the measurements (fits of gemm, lane and byte
# terms beside it moved from run to run), so the others are 0 and the
# cache is the card's 50 MB L2. ``tile`` is the least-squares fit over
# 16 blocked-tier calls (B = 8, four main-path shapes, four tilings) by
# ``chip_smoke.py`` phase 12 on one NVIDIA H100 80GB HBM3 at a 700 W
# power limit.
_ENGINE_CONSTANTS = {
    "cpu": dict(gemm=1 / 40e9, topk=9e-9, lane=1e-9, byte=1.5e-10,
                tile=50e-6, cache=24e6),
    "cuda": dict(gemm=0.0, topk=0.0, lane=0.0, byte=0.0,
                 tile=0.00021804507987627846, cache=50e6),
}


def engine_cost_estimate(
    n: int,
    m: int,
    d: int,
    kd: int,
    *,
    b: int = 1,
    block_n: int | None = None,
    block_m: int | None = None,
    merge: str = "select",
    fuse_norms: bool = False,
    backend: str = "cpu",
    select_group_w: int = 32,
    constants: dict | None = None,
) -> dict:
    """Analytical cost of one ``stream_topk`` call (seconds, by term).

    Mirrors the engine's dataflow: a (block_n x block_m) tile grid, a
    contraction + tile assembly per tile, and the selected merge.
    ``select`` costs one build pass over each tile plus kd O(G + w)
    rounds; ``topk`` a kd-deep selection sweep over every candidate;
    ``packed`` a pack pass plus the sort-network passes. Each tile pays
    a dispatch overhead (``tile``), and a live tile larger than the
    cache (``cache`` bytes) pays re-read traffic. ``constants`` replaces
    the backend's (a fit passes one-hot ones to read each term's units).
    """
    c = constants or _ENGINE_CONSTANTS.get(backend, _ENGINE_CONSTANTS["cpu"])
    bn = n if block_n is None else min(block_n, n)
    bm = m if block_m is None else min(block_m, m)
    nb_n = ceil_div(n, bn)
    nb_m = ceil_div(m, bm)
    rows = b * nb_n * bn  # padded query rows
    tile_elems = rows * nb_m * bm

    d_eff = d + 2 if fuse_norms else d
    gemm_s = 2.0 * tile_elems * d_eff * c["gemm"]
    # Tile assembly (norm adds + masks) reads/writes the tile unless the
    # norms were folded into the contraction.
    assembly_s = tile_elems * 4 * c["byte"] * (1 if fuse_norms else 3)

    if merge == "select":
        w = min(select_group_w, bm)
        groups = ceil_div(bm, w)
        build = tile_elems * c["lane"]
        rounds = rows * nb_m * kd * (groups + 2 * w) * c["lane"]
        final = 0.0 if nb_m == 1 else rows * nb_m * kd * c["topk"]
        merge_s = build + rounds + final
    elif merge == "packed":
        kd_pad = 1 if kd <= 1 else 1 << (kd - 1).bit_length()
        lg = clog2(kd_pad)
        pack = tile_elems * 2 * c["lane"]
        passes = rows * nb_m * (
            bm * (lg * (lg + 1) // 2 + lg + 1) + kd_pad * (lg + 1)
        ) * 1.5 * c["lane"]
        merge_s = pack + passes
    else:  # "topk"
        merge_s = rows * nb_m * (kd + bm) * c["topk"]

    overhead_s = nb_n * nb_m * c["tile"]
    live_tile_bytes = b * bn * bm * 4
    spill_s = (max(0.0, live_tile_bytes - c["cache"]) * nb_n * nb_m * 4
               * c["byte"])
    total = gemm_s + assembly_s + merge_s + overhead_s + spill_s
    return {
        "gemm_s": gemm_s,
        "assembly_s": assembly_s,
        "merge_s": merge_s,
        "overhead_s": overhead_s,
        "spill_s": spill_s,
        "total_s": total,
        "live_tile_bytes": live_tile_bytes,
    }


# On the CPU a ``cuda`` candidate runs the kernel's plain version (the
# full distance matrix and a stable sort per call), never the kernel:
# each call pays a fixed cost and a per-element cost far above the
# engine's, so the prior keeps those candidates out of the measured top-N
# there while on a card they compete on the Hopper estimate.
_CPU_PLAIN_CALL_S = 2e-3
_CPU_PLAIN_ELEM_S = 2e-8
# On a card each kernel call also pays a fixed cost the device estimate
# does not see: the Python wrapper's checks and the launch, and a
# launch's ramp. Fitted by ``chip_smoke.py`` phase 12 as the median, over
# its measured ``cuda`` candidates, of measured time minus the Hopper
# estimate (tensor-core compute term), on one NVIDIA H100 80GB HBM3 at a
# 700 W power limit.
_CUDA_KERNEL_CALL_S = 5.781054398802515e-05


def kernel_cost_estimate(
    n: int,
    m: int,
    d: int,
    kd: int,
    *,
    b: int = 1,
    block_n: int = CUDA_BLOCK_N,
    block_m: int = CUDA_CHUNK_M,
    kernel_merge: str = "bitonic",
    packed: bool = False,
    bucket_rounds: int = 0,
    mxu_bf16: bool = False,
    backend: str = "cpu",
    call_s: float | None = None,
) -> dict:
    """Analytical cost of one ``cuda`` DIGC call (tuner priors): on
    ``"cuda"`` the Hopper estimate times the batch plus a fixed per-call
    cost (``call_s``, default the fitted ``_CUDA_KERNEL_CALL_S``; a fit
    passes 0 to read the device estimate alone), the plain-version
    penalty everywhere else."""
    if backend != "cuda":
        blocks = b * ceil_div(n, block_n) * ceil_div(m, block_m)
        total = blocks * _CPU_PLAIN_CALL_S + b * n * m * _CPU_PLAIN_ELEM_S
        return {"total_s": total, "plain": True, "bound": "plain"}
    est = h100_digc_estimate(
        n, m, d, kd, 1, block_n=block_n, block_m=block_m, packed=packed,
        bucket_rounds=bucket_rounds, kernel_merge=kernel_merge,
        mxu_bf16=mxu_bf16,
    )
    call = _CUDA_KERNEL_CALL_S if call_s is None else call_s
    return {"total_s": est["latency_s"] * b + call, "device_s":
            est["latency_s"] * b, "call_s": call, "plain": False,
            "bound": est["bound"]}
