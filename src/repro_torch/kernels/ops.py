"""Public wrappers for the CUDA kernels (rank handling + NSM) and the
``cuda`` GraphBuilder, the counterpart of the JAX package's ``pallas``
builder, with MRConv as its fused aggregation.

Dispatch is by the device of the tensors passed in: CUDA tensors launch
the kernel (or raise), CPU tensors take the plain PyTorch version. There
is no fallback from one to the other.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.builder import DigcSpec, GraphBuilder, promote_batch, register
from repro_torch.device import runs_kernel
from repro_torch.kernels.digc_topk import digc_topk_cuda, digc_topk_plain
from repro_torch.kernels.mrconv import mrconv_cuda, mrconv_plain


def mrconv(x: torch.Tensor, y: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Fused max-relative aggregation.
    x: (B, N, D) | (N, D), y: (B, M, D) | (M, D), idx: (B, N, k) | (N, k)
    int32 -> aggregate of x's rank, in x's dtype (computed in fp32)."""
    if not (x.ndim == y.ndim == idx.ndim) or x.ndim not in (2, 3):
        raise ValueError(
            "mrconv expects (N, D)/(M, D)/(N, k) or uniformly batched "
            f"(B, ...) inputs; got {tuple(x.shape)}, {tuple(y.shape)}, "
            f"{tuple(idx.shape)}"
        )
    squeeze = x.ndim == 2
    if squeeze:
        x, y, idx = x[None], y[None], idx[None]
    fn = mrconv_cuda if runs_kernel(x) else mrconv_plain
    out = fn(x, y, idx).to(x.dtype)
    return out[0] if squeeze else out


def digc_topk(x: torch.Tensor, y: torch.Tensor, *, k: int, dilation: int = 1,
              pos_bias: Optional[torch.Tensor] = None, causal: bool = False,
              packed: bool = False, mxu_bf16: bool = False,
              return_dists: bool = False):
    """Fused DIGC with dilated selection.

    x: (B, N, D) | (N, D) nodes, y co-nodes of the same rank, pos_bias
    (B, N, M) | (N, M) or None. The kernel returns the full sorted
    top-(k*d); the stride-d slice here keeps every d-th entry. Returns idx
    (B, N, k) int32 [, dist] of x's rank.
    """
    x3, y3, p3, squeeze = promote_batch(x, y, pos_bias)
    m = y3.shape[1]
    kd = k * dilation
    if kd > m:
        raise ValueError(f"k*dilation={kd} exceeds number of co-nodes M={m}")
    fn = digc_topk_cuda if runs_kernel(x3) else digc_topk_plain
    dist, idx = fn(x3, y3, kd, p3, causal=causal, packed=packed,
                   mxu_bf16=mxu_bf16)
    if dilation > 1:
        dist = dist[..., ::dilation].contiguous()
        idx = idx[..., ::dilation].contiguous()
    if squeeze:
        dist, idx = dist[0], idx[0]
    if return_dists:
        return idx, dist
    return idx


def _build_cuda(x, y, pos_bias, spec: DigcSpec):
    if spec.kernel_merge not in (None, "bitonic", "legacy"):
        raise ValueError(f"unknown kernel_merge {spec.kernel_merge!r}; "
                         "expected 'bitonic' or 'legacy'")
    if spec.kernel_merge == "legacy" or (spec.bucket_rounds or 0) > 0:
        raise NotImplementedError(
            "the legacy kd-pass merge and bucket_rounds are not ported to the "
            "CUDA kernel (ROADMAP queue 2; they come with the tuner)"
        )
    return digc_topk(x, x if y is None else y, k=spec.k,
                     dilation=spec.dilation, pos_bias=pos_bias,
                     causal=spec.causal, packed=bool(spec.packed),
                     mxu_bf16=bool(spec.mxu_bf16), return_dists=True)


register(GraphBuilder(
    name="cuda",
    build=_build_cuda,
    knobs=frozenset({"packed", "mxu_bf16", "kernel_merge", "bucket_rounds"}),
    supports_pos_bias=True,
    supports_causal=True,
    aggregate=mrconv,
    doc="fused CUDA kernel: distance + running top-kd in shared memory, "
        "one block per (image, row tile); packed / bf16 / causal / pos_bias "
        "variants; MRConv as a direct row gather",
))
