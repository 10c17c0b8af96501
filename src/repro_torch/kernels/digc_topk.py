"""Fused DIGC: pairwise distance + sorted top-(k*d), as a CUDA kernel.

``digc_topk_cuda`` launches ``csrc/digc_topk.cu``, the Hopper port of
``repro/kernels/digc_topk.py::digc_topk_pallas`` (its unpacked, exact,
non-causal variant without positional bias). ``digc_topk_plain`` is the
same function in plain PyTorch: the tests hold the kernel against it and
the CPU path runs it. Both return the full sorted top-kd; the stride-d
neighbour selection happens in ``ops.digc_topk``.

The TPU kernel BIG-masks columns at or beyond ``m_valid`` because its
wrapper pads M up to a tile multiple. This wrapper pads nothing: the CUDA
kernel masks the ragged edge itself, so there is no pad column to mask.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import digc_reference

# Longest running list the kernel keeps per row (shared memory).
MAX_KD = 256

# Launches of the CUDA kernel in this process (read and reset by callers).
digc_topk_launches = 0


def digc_topk_plain(x: torch.Tensor, y: torch.Tensor, kd: int):
    """x (B, N, D), y (B, M, D) -> (dist f32, idx i32), each (B, N, kd),
    ascending by (distance, index): the full distance matrix, then a
    stable sort."""
    return digc_reference(x, y, kd=kd)


def digc_topk_cuda(x: torch.Tensor, y: torch.Tensor, kd: int):
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
    dist = torch.empty((b, n, kd), dtype=torch.float32, device=x.device)
    idx = torch.empty((b, n, kd), dtype=torch.int32, device=x.device)
    if b * n == 0:
        return dist, idx
    lib = _build.load().lib
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.digc_topk_launch(x.data_ptr(), y.data_ptr(),
                                    dist.data_ptr(), idx.data_ptr(),
                                    b, n, m, d, kd, stream)
    _build.check_launch(code, "digc_topk")
    digc_topk_launches += 1
    return dist, idx
