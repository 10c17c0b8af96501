"""Max-relative graph aggregation (MRConv), as a CUDA kernel.

    agg[b, i, :] = max_{j < k} (y[b, idx[b, i, j], :] - x[b, i, :])

``mrconv_cuda`` launches ``csrc/mrconv.cu``, the Hopper port of
``repro/kernels/mrconv.py::mrconv_pallas``: a direct row gather in place
of the TPU's one-hot matrix product. ``mrconv_plain`` is the same
function in plain PyTorch. Both compute in fp32 from a running max of
-1e30, and an index outside [0, M) contributes nothing; the change of
gather has no numerical effect, so the two agree bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG = -1e30

# Launches of the CUDA kernel in this process (read and reset by callers).
mrconv_launches = 0


def padded_rows(m: int) -> int:
    """The JAX wrapper's padded co-node count: M rounded up to its
    co-node block, ``min(512, M rounded up to 128)``."""
    block_m = min(512, -(-m // 128) * 128)
    return -(-m // block_m) * block_m


def mrconv_plain(x: torch.Tensor, y: torch.Tensor,
                 idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, D), y (B, M, D), idx (B, N, k) int -> (B, N, D) fp32."""
    b, n, k = idx.shape
    m, d = y.shape[1], y.shape[2]
    ids = idx.long()
    valid = (ids >= 0) & (ids < padded_rows(m))
    flat = ids.clamp(0, m - 1).reshape(b, n * k, 1).expand(b, n * k, d)
    neigh = torch.gather(y.float(), 1, flat).reshape(b, n, k, d)
    neigh = neigh.masked_fill((ids >= m)[..., None], 0.0)  # zero pad rows
    rel = (neigh - x.float()[:, :, None, :]).masked_fill(~valid[..., None], NEG)
    return rel.amax(dim=2)


def mrconv_cuda(x: torch.Tensor, y: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel on fp32 x, y and int32 idx on one card; same
    contract as ``mrconv_plain``."""
    global mrconv_launches
    if x.device.type != "cuda":
        raise ValueError(f"mrconv_cuda needs CUDA tensors, got {x.device}")
    _build.check_operand("x", x, dtype=torch.float32, ndim=3, device=x.device)
    _build.check_operand("y", y, dtype=torch.float32, ndim=3, device=x.device)
    _build.check_operand("idx", idx, dtype=torch.int32, ndim=3,
                         device=x.device)
    b, n, d = x.shape
    m, k = y.shape[1], idx.shape[2]
    if y.shape[0] != b or y.shape[2] != d or idx.shape[:2] != (b, n):
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, y "
                         f"{tuple(y.shape)}, idx {tuple(idx.shape)}")
    if m < 1 or k < 1:
        raise ValueError(f"mrconv needs M >= 1 and k >= 1; got M={m}, k={k}")
    out = torch.empty((b, n, d), dtype=torch.float32, device=x.device)
    if b * n * d == 0:
        return out
    lib = _build.load().lib
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.mrconv_launch(x.data_ptr(), y.data_ptr(), idx.data_ptr(),
                                 out.data_ptr(), b, n, m, padded_rows(m), d,
                                 k, stream)
    _build.check_launch(code, "mrconv")
    mrconv_launches += 1
    return out
