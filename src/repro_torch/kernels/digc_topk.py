"""Fused DIGC: pairwise distance + sorted top-(k*d), as a CUDA kernel.

``digc_topk_cuda`` launches ``csrc/digc_topk.cu``, the Hopper port of
``repro/kernels/digc_topk.py::digc_topk_pallas`` with both of its merges
and every variant of that kernel:

  * ``kernel_merge="bitonic"``: candidates merged into the running list by
    a warp bitonic sort and a rank merge; exact;
  * ``kernel_merge="legacy"``: kd extraction passes per merge
    (``_merge_body`` / ``_merge_body_packed``), walking M padded to a
    ``block_m`` multiple as the TPU kernel does. Exact lists start as
    (BIG, index 0), so BIG lanes carry index 0; packed lists start as
    ``INT_BIG`` and drop repeated keys (pad columns alias);
  * ``bucket_rounds=r`` (legacy, packed): each ``block_m`` tile keeps the
    r smallest distinct keys of each of kd buckets of ``block_m // kd``
    columns (``_bucket_reduce``) before the merge; approximate, and the
    result depends on ``block_m``;
  * ``packed``: one int32 (dist|idx) key per list entry
    (``core/packedkey.py``), ``idx_bits = idx_bits_for(M)`` of the true M;
    the returned distances carry the key's truncation;
  * ``mxu_bf16``: x and y rounded to bf16, norms taken from the rounded
    values in fp32 and products on the bf16 tensor cores with fp32 sums
    (the TPU kernel's rule; the fp32 variants multiply as split TF32);
  * ``pos_bias``: a (B, N, M) fp32 bias added before masking; a shared
    (1, N, M) bias (or its batch-expanded view) is read with batch
    stride 0;
  * ``causal``: columns with col > row get distance exactly BIG and keep
    their index.

``block_m`` is the number of columns merged at once: 64 (one staged
chunk) for the bitonic merge, which walks M itself and masks its ragged
edge, so it has no pad column; any for the legacy merge.

``digc_topk_plain`` is the same function in plain PyTorch: the full
distance matrix, the masks, then a stable sort (of packed keys for
``packed``; with the legacy fills, pad columns and causal tile skipping
for ``legacy``; per bucket, then over the survivors, for
``bucket_rounds``). The tests hold the kernel against it and the CPU
path runs it. Both return the full sorted top-kd; the stride-d neighbour
selection happens in ``ops.digc_topk``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import perfmodel
from repro_torch.core.perfmodel import ceil_div
from repro_torch.core.packedkey import INT_BIG, idx_bits_for, pack_keys, unpack_keys
from repro_torch.kernels import _build
from repro_torch.kernels.ref import pairwise_sq_dists

# Longest running list the kernel keeps per row (shared memory).
MAX_KD = perfmodel.CUDA_MAX_KD
# Packed keys of the TPU kernel hold at most 16 index bits.
MAX_PACKED_M = 65536
BIG = float(1e30)
# The kernel's row tile (its only block_n).
BLOCK_N = perfmodel.CUDA_BLOCK_N
KERNEL_MERGES = ("bitonic", "legacy")

VARIANTS = ("packed", "mxu_bf16", "causal", "pos_bias", "legacy",
            "bucket_rounds")

# Launches of the CUDA kernel in this process, all variants, and the
# launches with each variant switched on (read and reset by callers). A
# bucket_rounds launch runs the legacy merge and counts under both.
digc_topk_launches = 0
variant_launches = dict.fromkeys(VARIANTS, 0)

_FLAG_PACKED, _FLAG_BF16, _FLAG_CAUSAL = 1, 2, 4
_FLAG_LEGACY, _FLAG_BUCKET = 8, 16


def legacy_limits(n: int, m_walk: int, block_m: int, causal: bool,
                  row_tile: int, device=None) -> torch.Tensor:
    """(N,) one past the last column each row's legacy merge walks: every
    tile its row block of ``row_tile`` rows reaches (``j * block_m <= last
    row of the block``), the padded M when not causal."""
    if not causal:
        return torch.full((n,), m_walk, dtype=torch.int64, device=device)
    rows = torch.arange(n, device=device)
    last = rows // row_tile * row_tile + row_tile - 1
    return torch.clamp((last // block_m + 1) * block_m, max=m_walk)


def _unique_keys(keys: torch.Tensor) -> torch.Tensor:
    """Sorted keys along the last axis with repeats replaced by INT_BIG,
    and every key at or above INT_BIG made INT_BIG (the legacy packed
    merge's compare-mask)."""
    keys = torch.sort(keys, dim=-1).values
    rep = torch.zeros_like(keys, dtype=torch.bool)
    rep[..., 1:] = keys[..., 1:] == keys[..., :-1]
    keys = torch.where(rep | (keys >= INT_BIG), INT_BIG, keys)
    return torch.sort(keys, dim=-1).values


def _legacy_packed_keys(d: torch.Tensor, m: int, block_m: int, causal: bool,
                        row_tile: int, bits: int) -> torch.Tensor:
    """(B, N, M_pad) keys of the columns the legacy merge walks: M padded
    to a block_m multiple with pad columns at BIG, their column cut to
    ``bits``; columns past a row's causal limit are INT_BIG."""
    n = d.shape[-2]
    m_walk = ceil_div(m, block_m) * block_m
    d = torch.nn.functional.pad(d, (0, m_walk - m), value=BIG)
    cols = torch.arange(m_walk, device=d.device, dtype=torch.int32)
    keys = pack_keys(d, cols.expand_as(d), bits)
    lim = legacy_limits(n, m_walk, block_m, causal, row_tile, d.device)
    return torch.where(cols[None, :] < lim[:, None], keys, INT_BIG)


def digc_topk_plain(x: torch.Tensor, y: torch.Tensor, kd: int,
                    pos_bias: Optional[torch.Tensor] = None, *,
                    causal: bool = False, packed: bool = False,
                    mxu_bf16: bool = False,
                    kernel_merge: Optional[str] = None,
                    block_n: Optional[int] = None,
                    block_m: Optional[int] = None, bucket_rounds: int = 0):
    """x (B, N, D), y (B, M, D), pos_bias (B, N, M) or None -> (dist f32,
    idx i32), each (B, N, kd), ascending by (distance, index). Tiles and
    the merge resolve by ``resolve_kernel_args``; the legacy merge walks M
    padded to ``block_m`` and skips causal tiles by row blocks of the
    resolved ``row_tile`` rows."""
    kernel_merge, block_m, row_tile = resolve_kernel_args(
        x.shape[-2], y.shape[-2], x.shape[-1], kd, block_n=block_n,
        block_m=block_m, packed=packed, bucket_rounds=bucket_rounds,
        kernel_merge=kernel_merge)
    if mxu_bf16:
        x = x.to(torch.bfloat16)
        y = y.to(torch.bfloat16)
    d = pairwise_sq_dists(x, y, pos_bias)
    n, m = d.shape[-2:]
    if causal:
        rows = torch.arange(n, device=d.device)[:, None]
        cols = torch.arange(m, device=d.device)[None, :]
        d = torch.where(cols <= rows, d, BIG)
    legacy = kernel_merge == "legacy"
    if packed:
        bits = idx_bits_for(m)
        if not legacy:
            cols = torch.arange(m, device=d.device, dtype=torch.int32)
            keys = torch.sort(pack_keys(d, cols.expand_as(d), bits),
                              dim=-1).values
            return unpack_keys(keys[..., :kd], bits)
        keys = _legacy_packed_keys(d, m, block_m, causal, row_tile, bits)
        if bucket_rounds > 0:
            w = block_m // kd
            buckets = _unique_keys(keys.reshape(*keys.shape[:-1], -1, kd, w))
            short = bucket_rounds - w
            if short > 0:
                buckets = torch.nn.functional.pad(buckets, (0, short),
                                                  value=INT_BIG)
            keys = buckets[..., :bucket_rounds].reshape(*keys.shape[:-1], -1)
        keys = _unique_keys(keys)
        short = kd - keys.shape[-1]
        if short > 0:
            keys = torch.nn.functional.pad(keys, (0, short), value=INT_BIG)
        return unpack_keys(keys[..., :kd], bits)
    if legacy:
        # kd (BIG, index 0) entries ahead of every column: the legacy
        # list's initial fill, which a BIG column never displaces.
        lead = d.new_full(d.shape[:-1] + (kd,), BIG)
        d = torch.cat([lead, d], dim=-1)
    dist, idx = torch.sort(d, dim=-1, stable=True)
    idx = idx[..., :kd]
    if legacy:
        idx = torch.clamp(idx - kd, min=0)
    return dist[..., :kd], idx.to(torch.int32)


def _pos_operand(pos_bias: torch.Tensor, b: int, n: int, m: int):
    """(tensor, batch stride) for the kernel: a per-image (B, N, M) bias,
    or a shared one with stride 0, without copying it per image."""
    if pos_bias.ndim != 3 or tuple(pos_bias.shape[1:]) != (n, m) \
            or pos_bias.shape[0] not in (1, b):
        raise ValueError(f"pos_bias {tuple(pos_bias.shape)} must be (B, N, M) "
                         f"or (1, N, M) with N={n}, M={m}, B={b}")
    if pos_bias.shape[0] == 1 or pos_bias.stride(0) == 0:
        shared = pos_bias[0]
        _build.check_operand("pos_bias", shared, dtype=torch.float32, ndim=2,
                             device=pos_bias.device)
        return shared, 0
    _build.check_operand("pos_bias", pos_bias, dtype=torch.float32, ndim=3,
                         device=pos_bias.device)
    return pos_bias, n * m


def kernel_buffer(kd: int, block_m: int, packed: bool, bucket_rounds: int,
                  legacy: bool) -> int:
    """The kernel's per-row buffer: none for the bitonic merge (it merges
    each staged chunk), kd * rounds bucket survivors, else the legacy
    candidates between merges (a staged chunk at least, ``block_m``
    rounded up to chunks at most, within the shared-memory budget)."""
    if not legacy:
        return 0
    if bucket_rounds > 0:
        return kd * bucket_rounds
    chunk = perfmodel.CUDA_CHUNK_M
    return max(chunk, min(ceil_div(block_m, chunk) * chunk,
                          perfmodel.cuda_merge_buffer(kd, 4 if packed else 8)))


def resolve_kernel_args(n: int, m: int, d: int, kd: int, *,
                        block_n: Optional[int] = None,
                        block_m: Optional[int] = None, packed: bool = False,
                        bucket_rounds: int = 0,
                        kernel_merge: Optional[str] = None
                        ) -> tuple[str, int, int]:
    """(kernel_merge, block_m, row_tile) of one call, by the JAX wrapper's
    rules, or ValueError: the only place the kernel's tiles are defaulted
    and checked (both wrappers below call it; resolving resolved values
    returns them unchanged).

    ``kernel_merge=None`` is "legacy" with ``bucket_rounds``, else
    "bitonic". ``block_n`` must be None or the kernel's row tile. The
    bitonic merge runs on every staged chunk: its block_m is 64, the
    Hopper default (``perfmodel.kernel_tile_defaults``), and its result
    does not depend on the tiles. The legacy merge walks the TPU kernel's
    tiles (pad columns, causal tile skipping, buckets), so its unset ones
    take the JAX package's default (``perfmodel.pallas_tile_defaults``)
    and both packages walk the same columns. Then ``block_m = min(block_m,
    ceil_to(M, 128))`` and the causal row block ``row_tile = min(block_n,
    ceil_to(N, 8))``. A kd or tile the kernel cannot hold (``MAX_KD``, the
    shared-memory budget) raises too."""
    if kernel_merge is None:
        kernel_merge = "legacy" if bucket_rounds > 0 else "bitonic"
    if kernel_merge not in KERNEL_MERGES:
        raise ValueError(f"unknown kernel_merge {kernel_merge!r}; expected "
                         f"one of {KERNEL_MERGES}")
    if block_n is not None and block_n != BLOCK_N:
        raise ValueError(f"the CUDA kernel's row tile is {BLOCK_N} rows; got "
                         f"block_n={block_n}")
    legacy = kernel_merge == "legacy"
    defaults = (perfmodel.pallas_tile_defaults if legacy
                else perfmodel.kernel_tile_defaults)(n, m, d, kd)
    rows = defaults[0] if block_n is None else block_n
    block_m = defaults[1] if block_m is None else block_m
    block_m = min(block_m, ceil_div(m, 128) * 128)
    if bucket_rounds > 0:
        if not legacy:
            raise ValueError(
                "bucket_rounds pre-reduction belongs to the legacy merge; "
                f"got kernel_merge={kernel_merge!r} with "
                f"bucket_rounds={bucket_rounds}")
        if not packed:
            raise ValueError("bucket_rounds requires packed=True keys")
        if block_m % kd != 0 or block_m // kd < 2:
            raise ValueError(
                "bucket_rounds requires block_m % kd == 0 and "
                f"block_m // kd >= 2; got block_m={block_m}, kd={kd}")
    if packed and m > MAX_PACKED_M:
        raise ValueError("packed keys hold u16 indices: require M <= "
                         f"{MAX_PACKED_M}, got M={m}")
    if kd > MAX_KD:
        raise ValueError(f"kd={kd} exceeds the kernel's MAX_KD={MAX_KD}")
    if not legacy and block_m != perfmodel.CUDA_CHUNK_M:
        raise ValueError(
            f"the bitonic merge runs on every staged chunk of "
            f"{perfmodel.CUDA_CHUNK_M} columns; got block_m={block_m}")
    if block_m < 1:
        raise ValueError(f"block_m must be >= 1, got {block_m}")
    buf = kernel_buffer(kd, block_m, packed, bucket_rounds, legacy)
    smem = perfmodel.cuda_static_smem(legacy) + perfmodel.cuda_dynamic_smem(
        kd, buf, 4 if packed else 8, legacy)
    limit = perfmodel.H100Config().smem_per_block
    if smem > limit:
        raise ValueError(
            f"kd={kd} with bucket_rounds={bucket_rounds} needs {smem} bytes "
            f"of shared memory per block; the card gives at most {limit}")
    return kernel_merge, block_m, min(rows, ceil_div(n, 8) * 8)


def digc_topk_cuda(x: torch.Tensor, y: torch.Tensor, kd: int,
                   pos_bias: Optional[torch.Tensor] = None, *,
                   causal: bool = False, packed: bool = False,
                   mxu_bf16: bool = False,
                   kernel_merge: Optional[str] = None,
                   block_n: Optional[int] = None,
                   block_m: Optional[int] = None, bucket_rounds: int = 0):
    """The CUDA kernel on fp32 (B, N, D) / (B, M, D) tensors on one card;
    same contract as ``digc_topk_plain``."""
    global digc_topk_launches
    if x.device.type != "cuda":
        raise ValueError(f"digc_topk_cuda needs CUDA tensors, got {x.device}")
    _build.check_operand("x", x, dtype=torch.float32, ndim=3, device=x.device)
    _build.check_operand("y", y, dtype=torch.float32, ndim=3, device=x.device)
    b, n, d = x.shape
    if y.shape[0] != b or y.shape[2] != d:
        raise ValueError(f"x {tuple(x.shape)} and y {tuple(y.shape)} differ "
                         "in batch or feature size")
    m = y.shape[1]
    if not 1 <= kd <= m:
        raise ValueError(f"kd={kd} must lie in [1, M={m}]")
    kernel_merge, block_m, row_tile = resolve_kernel_args(
        n, m, d, kd, block_n=block_n, block_m=block_m, packed=packed,
        bucket_rounds=bucket_rounds, kernel_merge=kernel_merge)
    legacy = kernel_merge == "legacy"
    idx_bits = idx_bits_for(m) if packed else 0
    pos, pos_stride = None, 0
    if pos_bias is not None:
        if pos_bias.device != x.device:
            raise ValueError(f"pos_bias is on {pos_bias.device}, expected "
                             f"{x.device}")
        pos, pos_stride = _pos_operand(pos_bias, b, n, m)
    flags = ((_FLAG_PACKED if packed else 0) | (_FLAG_BF16 if mxu_bf16 else 0)
             | (_FLAG_CAUSAL if causal else 0)
             | (_FLAG_LEGACY if legacy else 0)
             | (_FLAG_BUCKET if bucket_rounds > 0 else 0))
    m_walk = ceil_div(m, block_m) * block_m if legacy else m
    dist = torch.empty((b, n, kd), dtype=torch.float32, device=x.device)
    idx = torch.empty((b, n, kd), dtype=torch.int32, device=x.device)
    if b * n == 0:
        return dist, idx
    lib = _build.load().lib
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.digc_topk_launch(
            x.data_ptr(), y.data_ptr(), None if pos is None else pos.data_ptr(),
            pos_stride, dist.data_ptr(), idx.data_ptr(), b, n, m, d, kd, flags,
            idx_bits, block_m,
            kernel_buffer(kd, block_m, packed, bucket_rounds, legacy),
            bucket_rounds,
            m_walk, row_tile, stream)
    _build.check_launch(code, "digc_topk")
    digc_topk_launches += 1
    for name, on in zip(VARIANTS, (packed, mxu_bf16, causal, pos is not None,
                                   legacy, bucket_rounds > 0)):
        variant_launches[name] += on
    return dist, idx
