"""Fused DIGC: pairwise distance + sorted top-(k*d), as a CUDA kernel.

``digc_topk_cuda`` launches ``csrc/digc_topk.cu``, the Hopper port of
``repro/kernels/digc_topk.py::digc_topk_pallas`` with its bitonic merge
and the variants of that kernel:

  * ``packed``: one int32 (dist|idx) key per list entry
    (``core/packedkey.py``), ``idx_bits = idx_bits_for(M)`` of the true M;
    the returned distances carry the key's truncation;
  * ``mxu_bf16``: x and y rounded to bf16, norms and products taken from
    the rounded values in fp32 (the TPU kernel's rule);
  * ``pos_bias``: a (B, N, M) fp32 bias added before masking; a shared
    (1, N, M) bias (or its batch-expanded view) is read with batch
    stride 0;
  * ``causal``: columns with col > row get distance exactly BIG and keep
    their index.

``digc_topk_plain`` is the same function in plain PyTorch: the full
distance matrix, the masks, then a stable sort (of packed keys for
``packed``). The tests hold the kernel against it and the CPU path runs
it. Both return the full sorted top-kd; the stride-d neighbour selection
happens in ``ops.digc_topk``.

The TPU kernel BIG-masks columns at or beyond ``m_valid`` because its
wrapper pads M up to a tile multiple. This wrapper pads nothing: the CUDA
kernel masks the ragged edge itself, so there is no pad column to mask.
The ``legacy`` merge and ``bucket_rounds`` are not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.packedkey import idx_bits_for, pack_keys, unpack_keys
from repro_torch.kernels import _build
from repro_torch.kernels.ref import pairwise_sq_dists

# Longest running list the kernel keeps per row (shared memory).
MAX_KD = 256
# Packed keys of the TPU kernel hold at most 16 index bits.
MAX_PACKED_M = 65536
BIG = float(1e30)

VARIANTS = ("packed", "mxu_bf16", "causal", "pos_bias")

# Launches of the CUDA kernel in this process, all variants, and the
# launches with each variant switched on (read and reset by callers).
digc_topk_launches = 0
variant_launches = dict.fromkeys(VARIANTS, 0)

_FLAG_PACKED, _FLAG_BF16, _FLAG_CAUSAL = 1, 2, 4


def _check_packed_m(m: int) -> int:
    if m > MAX_PACKED_M:
        raise ValueError(f"packed keys hold u16 indices: require M <= "
                         f"{MAX_PACKED_M}, got M={m}")
    return idx_bits_for(m)


def digc_topk_plain(x: torch.Tensor, y: torch.Tensor, kd: int,
                    pos_bias: Optional[torch.Tensor] = None, *,
                    causal: bool = False, packed: bool = False,
                    mxu_bf16: bool = False):
    """x (B, N, D), y (B, M, D), pos_bias (B, N, M) or None -> (dist f32,
    idx i32), each (B, N, kd), ascending by (distance, index)."""
    if mxu_bf16:
        x = x.to(torch.bfloat16)
        y = y.to(torch.bfloat16)
    d = pairwise_sq_dists(x, y, pos_bias)
    n, m = d.shape[-2:]
    if causal:
        rows = torch.arange(n, device=d.device)[:, None]
        cols = torch.arange(m, device=d.device)[None, :]
        d = torch.where(cols <= rows, d, BIG)
    if packed:
        bits = _check_packed_m(m)
        cols = torch.arange(m, device=d.device, dtype=torch.int32)
        keys = torch.sort(pack_keys(d, cols.expand_as(d), bits), dim=-1).values
        return unpack_keys(keys[..., :kd], bits)
    dist, idx = torch.sort(d, dim=-1, stable=True)
    return dist[..., :kd], idx[..., :kd].to(torch.int32)


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


def digc_topk_cuda(x: torch.Tensor, y: torch.Tensor, kd: int,
                   pos_bias: Optional[torch.Tensor] = None, *,
                   causal: bool = False, packed: bool = False,
                   mxu_bf16: bool = False):
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
    if kd > MAX_KD:
        raise ValueError(f"kd={kd} exceeds the kernel's MAX_KD={MAX_KD}")
    idx_bits = _check_packed_m(m) if packed else 0
    pos, pos_stride = None, 0
    if pos_bias is not None:
        if pos_bias.device != x.device:
            raise ValueError(f"pos_bias is on {pos_bias.device}, expected "
                             f"{x.device}")
        pos, pos_stride = _pos_operand(pos_bias, b, n, m)
    flags = ((_FLAG_PACKED if packed else 0) | (_FLAG_BF16 if mxu_bf16 else 0)
             | (_FLAG_CAUSAL if causal else 0))
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
            idx_bits, stream)
    _build.check_launch(code, "digc_topk")
    digc_topk_launches += 1
    for name, on in zip(VARIANTS, (packed, mxu_bf16, causal, pos is not None)):
        variant_launches[name] += on
    return dist, idx
