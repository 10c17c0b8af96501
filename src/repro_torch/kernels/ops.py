"""Public wrappers for the CUDA kernels (rank handling + NSM) and the
``cuda`` GraphBuilder, the counterpart of the JAX package's ``pallas``
builder, with MRConv as its fused aggregation.

Dispatch is by the device of the tensors passed in: CUDA tensors launch
the kernel (or raise), CPU tensors take the plain PyTorch version. There
is no fallback from one to the other.

Neither kernel has a backward. DIGC returns integer indices, through
which no gradient flows, so it needs no guard. MRConv's output carries
the gradient of the Grapher's aggregation: on CUDA tensors under grad it
raises (``mrconv``), as JAX's ``pallas`` aggregate cannot be
differentiated, rather than return a tensor that silently drops it.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.builder import DigcSpec, GraphBuilder, promote_batch, register
from repro_torch.device import runs_kernel
from repro_torch.kernels.digc_topk import (  # noqa: F401 (re-exported)
    digc_topk_cuda,
    digc_topk_plain,
    resolve_kernel_args,
)
from repro_torch.kernels.mrconv import mrconv_cuda, mrconv_plain


def mrconv(x: torch.Tensor, y: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Fused max-relative aggregation.
    x: (B, N, D) | (N, D), y: (B, M, D) | (M, D), idx: (B, N, k) | (N, k)
    int32 -> aggregate of x's rank, in x's dtype (computed in fp32).
    Raises ``NotImplementedError`` on CUDA tensors when grad mode is on and
    x or y requires grad: the kernel has no backward."""
    if not (x.ndim == y.ndim == idx.ndim) or x.ndim not in (2, 3):
        raise ValueError(
            "mrconv expects (N, D)/(M, D)/(N, k) or uniformly batched "
            f"(B, ...) inputs; got {tuple(x.shape)}, {tuple(y.shape)}, "
            f"{tuple(idx.shape)}"
        )
    squeeze = x.ndim == 2
    if squeeze:
        x, y, idx = x[None], y[None], idx[None]
    kernel = runs_kernel(x)
    if kernel and torch.is_grad_enabled() and (x.requires_grad
                                                or y.requires_grad):
        raise NotImplementedError(
            "the MRConv kernel has no backward: the 'cuda' tier cannot "
            "train (as JAX's 'pallas' cannot); train through a tier whose "
            "aggregate is plain PyTorch: 'reference', 'blocked', 'cluster' "
            "or 'axial' (ROADMAP queue 3, item 20)")
    fn = mrconv_cuda if kernel else mrconv_plain
    out = fn(x, y, idx).to(x.dtype)
    return out[0] if squeeze else out


def digc_topk(x: torch.Tensor, y: torch.Tensor, *, k: int, dilation: int = 1,
              pos_bias: Optional[torch.Tensor] = None, causal: bool = False,
              packed: bool = False, mxu_bf16: bool = False,
              block_n: Optional[int] = None, block_m: Optional[int] = None,
              bucket_rounds: int = 0, kernel_merge: Optional[str] = None,
              return_dists: bool = False):
    """Fused DIGC with dilated selection.

    x: (B, N, D) | (N, D) nodes, y co-nodes of the same rank, pos_bias
    (B, N, M) | (N, M) or None. Tiles and the merge resolve by
    ``resolve_kernel_args``. The kernel returns the full sorted top-(k*d);
    the stride-d slice here keeps every d-th entry. Returns idx (B, N, k)
    int32 [, dist] of x's rank.
    """
    x3, y3, p3, squeeze = promote_batch(x, y, pos_bias)
    m = y3.shape[1]
    kd = k * dilation
    if kd > m:
        raise ValueError(f"k*dilation={kd} exceeds number of co-nodes M={m}")
    fn = digc_topk_cuda if runs_kernel(x3) else digc_topk_plain
    dist, idx = fn(x3, y3, kd, p3, causal=causal, packed=packed,
                   mxu_bf16=mxu_bf16, kernel_merge=kernel_merge,
                   block_n=block_n, block_m=block_m,
                   bucket_rounds=bucket_rounds)
    if dilation > 1:
        dist = dist[..., ::dilation].contiguous()
        idx = idx[..., ::dilation].contiguous()
    if squeeze:
        dist, idx = dist[0], idx[0]
    if return_dists:
        return idx, dist
    return idx


def _build_cuda(x, y, pos_bias, spec: DigcSpec):
    return digc_topk(x, x if y is None else y, k=spec.k,
                     dilation=spec.dilation, pos_bias=pos_bias,
                     causal=spec.causal, packed=bool(spec.packed),
                     mxu_bf16=bool(spec.mxu_bf16), block_n=spec.block_n,
                     block_m=spec.block_m,
                     bucket_rounds=spec.bucket_rounds or 0,
                     kernel_merge=spec.kernel_merge, return_dists=True)


register(GraphBuilder(
    name="cuda",
    build=_build_cuda,
    knobs=frozenset({"block_n", "block_m", "packed", "mxu_bf16",
                     "bucket_rounds", "kernel_merge"}),
    supports_pos_bias=True,
    supports_causal=True,
    aggregate=mrconv,
    doc="fused CUDA kernel: distance + running top-kd in shared memory, "
        "one block per (image, 16-row tile); bitonic or legacy merge every "
        "block_m columns, bucket_rounds pre-reduction; packed / bf16 / "
        "causal / pos_bias variants; MRConv as a direct row gather",
))
