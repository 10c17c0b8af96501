"""Routed experts of a Mixture-of-Experts layer over (token, expert) pairs
grouped by expert, as a CUDA kernel.

    out[t] = sum_j gates[t, j] * (silu(x[t] W_gate[e]) * (x[t] W_up[e])) W_down[e]

with ``e = sel[t, j]``: each selected pair is computed once, where JAX's
single-device MoE (``repro/models/moe.py::_dense_moe``) runs every expert
on every token. ``dispatch`` groups the pairs by expert on the device,
with no host read: flat pair indices sorted stably by expert (a dead row's
pairs given the sentinel expert E, so sorted last and in no group) and
each expert's row offsets. ``moe_experts_cuda`` launches
``csrc/moe_experts.cu`` on them (pass 1 gate and up with SiLU * up, pass
2 down, then the gate-weighted combine); ``moe_experts_plain`` is the same
arithmetic in plain PyTorch. Both round where ``_dense_moe`` rounds (each
product's fp32 sums to the operands' type, SiLU(gate), its product with
up, and y) and combine a token's pairs in fp32 in j order; a dead row's
output is 0. A row's result never depends on the other rows: the plain
version multiplies in zero-padded tiles of ``PLAIN_BM`` rows, batched with
each tile's expert weights gathered, so that no product's shape depends
on a group's size.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.device import runs_kernel
from repro_torch.kernels import _build

MAX_EXPERTS = 256  # the kernel keeps its tile table in shared memory
PLAIN_BM = 16  # rows a product of the plain version
PLAIN_TILES = 64  # products a batched call (each tile's experts gathered)
# Rows a tile of the bf16 kernel, by the mean pairs an expert (T K / E):
# 16 up to 16 (decode), 64 up to 64, else 128 (on an H100 at
# DeepSeek-V2-Lite's widths, 64 is the faster at 512 tokens and 128 at
# 1,024 and more); fp32 always 16.
TILE_ROWS = (16, 64, 128)
# D and F: multiples of a 16-byte bf16 chunk (the last column tile and
# depth stage are masked), for either operand type.
WIDTH_UNIT = 8
KERNEL_DTYPES = (torch.bfloat16, torch.float32)

# Launches of the CUDA kernel in this process, one per call (its two
# expert passes and the combine); read and reset by callers.
moe_experts_launches = 0


def dispatch(sel: torch.Tensor, live: Optional[torch.Tensor],
             n_experts: int) -> tuple[torch.Tensor, torch.Tensor]:
    """sel (T, K) expert ids, live (T,) bool or None -> (perm (T K,) int64:
    the flat pair indices t K + j in expert order, stable; row_off (E + 1,)
    int32: expert e's pairs are perm[row_off[e]:row_off[e + 1]]). A dead
    row's pairs take the sentinel E and follow every group. Device ops
    only, nothing read back: it records inside a CUDA graph."""
    eid = sel if live is None else torch.where(live[:, None], sel, n_experts)
    eid, perm = torch.sort(eid.reshape(-1), stable=True)
    bounds = torch.arange(n_experts + 1, device=sel.device, dtype=eid.dtype)
    return perm, torch.searchsorted(eid, bounds, out_int32=True)


def tile_rows(tokens: torch.Tensor, k: int, n_experts: int) -> int:
    """The kernel's rows a tile for T = ``tokens.shape[0]`` tokens: the
    smallest of ``TILE_ROWS`` at or above the mean pairs an expert, else
    the largest (fp32: 16)."""
    if tokens.dtype != torch.bfloat16:
        return TILE_ROWS[0]
    mean = tokens.shape[0] * k / n_experts
    return next((bm for bm in TILE_ROWS if mean <= bm), TILE_ROWS[-1])


def moe_experts_plain(tokens, w_gate, w_up, w_down, perm, row_off, gates,
                      live=None) -> torch.Tensor:
    """tokens (T, D), w_gate / w_up (E, D, F), w_down (E, F, D), perm and
    row_off from ``dispatch``, gates (T, K) fp32, live (T,) bool or None ->
    (T, D) in the tokens' type. Walks the kernel's tile table, built by
    tensor ops: every tile a routing could need, those past the last one
    computed and dropped, so that nothing is read back to the host."""
    t, k = gates.shape
    n_pairs, d = perm.numel(), tokens.shape[1]
    n_exp, bm, dev = w_gate.shape[0], PLAIN_BM, tokens.device
    tiles = (row_off[1:] - row_off[:-1] + bm - 1) // bm
    tile_off = F.pad(torch.cumsum(tiles, 0), (1, 0))  # (E + 1,)
    n_tiles = -(-n_pairs // bm) + n_exp
    tile = torch.arange(n_tiles, device=dev)
    expert = (torch.searchsorted(tile_off, tile, right=True) - 1).clamp(max=n_exp - 1)
    rows = (row_off[expert] + (tile - tile_off[expert]) * bm)[:, None] + \
        torch.arange(bm, device=dev)
    valid = (tile < tile_off[-1])[:, None] & (rows < row_off[expert + 1][:, None])
    pairs = perm[rows.clamp(max=n_pairs - 1)]  # (tiles, bm) flat pair ids
    a = torch.where(valid[..., None], tokens[pairs // k], 0)
    ys = []
    for c in range(0, n_tiles, PLAIN_TILES):  # the dense form's operations
        e = expert[c:c + PLAIN_TILES]
        h = F.silu(torch.bmm(a[c:c + PLAIN_TILES], w_gate.index_select(0, e))) * \
            torch.bmm(a[c:c + PLAIN_TILES], w_up.index_select(0, e))
        ys.append(torch.bmm(h, w_down.index_select(0, e)).reshape(-1, d))
    # a dead pair's row stays 0; rows past a tile's pairs land in a spare row
    y = tokens.new_zeros(n_pairs + 1, d).index_copy_(
        0, torch.where(valid, pairs, n_pairs).reshape(-1), torch.cat(ys))
    y = y[:n_pairs].reshape(t, k, d)
    out = torch.zeros(t, d, dtype=torch.float32, device=dev)
    for j in range(k):
        out = out + gates[:, j, None] * y[:, j].float()
    if live is not None:
        out = torch.where(live[:, None], out, 0.0)
    return out.to(tokens.dtype)


def moe_experts_cuda(tokens, w_gate, w_up, w_down, perm, row_off, gates,
                     live=None) -> torch.Tensor:
    """The CUDA kernel on one card; the contract of ``moe_experts_plain``
    (the row offsets stay on the device). bf16 or fp32 operands, D and F
    multiples of ``WIDTH_UNIT``, at most ``MAX_EXPERTS`` experts."""
    global moe_experts_launches
    dev, dt = tokens.device, tokens.dtype
    if dev.type != "cuda":
        raise ValueError(f"moe_experts_cuda needs CUDA tensors, got {dev}")
    if dt not in KERNEL_DTYPES:
        raise TypeError(f"the expert kernel takes bf16 or fp32 operands, "
                        f"got {dt}")
    t, d = tokens.shape
    e, _, f = w_gate.shape
    k = gates.shape[1]
    for name, x, ndim in (("tokens", tokens, 2), ("w_gate", w_gate, 3),
                          ("w_up", w_up, 3), ("w_down", w_down, 3)):
        _build.check_operand(name, x, dtype=dt, ndim=ndim, device=dev)
    _build.check_operand("perm", perm, dtype=torch.int64, ndim=1, device=dev)
    _build.check_operand("row_off", row_off, dtype=torch.int32, ndim=1,
                         device=dev)
    _build.check_operand("gates", gates, dtype=torch.float32, ndim=2,
                         device=dev)
    if live is not None:
        _build.check_operand("live", live, dtype=torch.bool, ndim=1,
                             device=dev)
    if (w_gate.shape != (e, d, f) or w_up.shape != (e, d, f)
            or w_down.shape != (e, f, d) or gates.shape[0] != t
            or perm.shape != (t * k,) or row_off.shape != (e + 1,)
            or (live is not None and live.shape != (t,))):
        raise ValueError(
            f"shapes disagree: tokens {tuple(tokens.shape)}, w_gate "
            f"{tuple(w_gate.shape)}, w_up {tuple(w_up.shape)}, w_down "
            f"{tuple(w_down.shape)}, perm {tuple(perm.shape)}, row_off "
            f"{tuple(row_off.shape)}, gates {tuple(gates.shape)}")
    if d % WIDTH_UNIT or f % WIDTH_UNIT:
        raise ValueError(f"the expert kernel takes D and F multiples of "
                         f"{WIDTH_UNIT}; got D={d}, F={f}")
    if not 1 <= e <= MAX_EXPERTS:
        raise ValueError(f"the expert kernel takes 1 to {MAX_EXPERTS} "
                         f"experts; got {e}")
    bm = tile_rows(tokens, k, e)
    if (t * k + bm - 1) // bm + e > 65535:
        raise ValueError(f"{t} tokens x {k} experts exceed the kernel's "
                         "65,535 row tiles")
    h = torch.empty((t * k, f), dtype=dt, device=dev)
    y = torch.empty((t * k, d), dtype=dt, device=dev)
    out = torch.empty((t, d), dtype=dt, device=dev)
    lib = _build.load(_build.MOE_LIB_NAME).lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.moe_experts_launch(
            tokens.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
            w_down.data_ptr(), perm.data_ptr(), row_off.data_ptr(),
            gates.data_ptr(), None if live is None else live.data_ptr(),
            h.data_ptr(), y.data_ptr(), out.data_ptr(), t, k, e, d, f,
            int(dt == torch.bfloat16), bm, stream)
    _build.check_launch(code, "moe_experts", _build.MOE_LIB_NAME)
    moe_experts_launches += 1
    return out


def moe_experts(tokens, w_gate, w_up, w_down, sel, gates, live=None):
    """tokens (T, D), the experts' weights, the router's sel (T, K) and
    gates (T, K) fp32, live (T,) bool or None (every row live) -> (T, D) in
    the tokens' type: each live row's gate-weighted experts, 0 for a dead
    row. CUDA tensors launch the kernel (or raise), CPU tensors take the
    plain version. No backward."""
    perm, row_off = dispatch(sel, live, w_gate.shape[0])
    fn = moe_experts_cuda if runs_kernel(tokens) else moe_experts_plain
    return fn(tokens, w_gate, w_up, w_down, perm, row_off,
              gates.contiguous(), live)
