"""Roofline terms of one step, counted on ``meta`` tensors (port of
``repro/launch/roofline.py``).

    compute term    = FLOPs / peak FLOP/s
    memory term     = bytes moved / HBM bandwidth
    collective term = collective bytes / link bandwidth

JAX reads XLA's ``cost_analysis()`` of a compiled, partitioned program.
The port has no compiler between the step and the card, so ``count``
runs the step once on ``meta`` tensors (shapes only, no storage) under a
``TorchDispatchMode`` that sees every aten operation the eager program
issues, autograd's backward and recomputed layers included:

* FLOPs: 2·m·n·k for each ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` /
  ``convolution`` (``torch.utils.flop_counter``'s formulas), one an input
  element for a reduction, none for data movement (copies, gathers,
  concatenates, fills) and one a output element for every other floating
  operation, as XLA counts its elementwise work;
* bytes: each operation reads its inputs and writes its outputs once.
  That is the eager program the port runs, with no fusion, so it is an
  upper bound on XLA's fused "bytes accessed";
* the peak of live intermediate bytes: each operation's output counts
  from its creation until its last reference (views and its own views
  included) dies, through ``weakref.finalize``; views, in-place results
  and the step's arguments add nothing.

``parse_collectives`` (XLA's HLO text) has no counterpart: the port has
no HLO and no partitioner (ROADMAP queue 3, item 25). ``collective_bytes``
takes its role as a lower bound by plan, not a measurement: each
parameter leaf sharded over axes of g devices is all-gathered once in the
forward at bytes·(g−1)/g, and a ``train`` step gathers it again for the
backward and reduce-scatters its gradient in fp32. Activations'
collectives are not counted.

Hardware constants: one NVIDIA H100 SXM, from ``core/perfmodel.py``
(989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s HBM3). The
collective rate is that of the link the production meshes cross. Ranks
are laid out row-major over (16, 16) (``launch/mesh.py``), eight GPUs a
node on NVLink (450 GB/s a direction), so a model axis of 16 spans two
nodes and every data-axis hop leaves its node: the per-GPU inter-node
rate, one 400 Gb/s InfiniBand NDR port a GPU (50 GB/s), sets the pace.
"""

from __future__ import annotations

import math
import weakref
from dataclasses import dataclass
from typing import Callable, Mapping

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.perfmodel import H100Config

PEAK_FLOPS = H100Config().peak_bf16_flops
HBM_BW = H100Config().hbm_bw
LINK_BW = 50e9  # one 400 Gb/s InfiniBand NDR port per GPU: the mesh's pace

# Allocation without a write: the output's bytes are live, none move.
_ALLOC = ("empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided")
# Data movement and fills: no arithmetic (XLA counts none for its copies,
# concatenates, gathers, scatters, pads and broadcasts).
_MOVES = frozenset(_ALLOC + (
    "clone", "copy", "copy_", "cat", "stack", "index", "index_select",
    "gather", "scatter", "scatter_", "index_put", "index_put_", "embedding",
    "constant_pad_nd", "repeat", "fill", "fill_", "zero_", "zeros",
    "zeros_like", "ones", "ones_like", "full", "full_like", "new_zeros",
    "new_ones", "new_full", "arange", "scalar_tensor", "slice_scatter",
    "select_scatter", "lift_fresh_copy"))
# Reductions: one operation an input element, as XLA counts a reduce.
_REDUCES = frozenset((
    "sum", "mean", "amax", "amin", "max", "min", "prod", "_softmax",
    "_log_softmax", "logsumexp", "var", "var_mean", "std", "norm",
    "linalg_vector_norm", "cumsum", "cumprod", "argmax", "argmin", "all",
    "any", "topk", "sort"))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(values) -> list:
    """The tensors among ``values`` and inside their lists and tuples (an
    aten operation's arguments and results nest no deeper)."""
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(x for x in v if isinstance(x, torch.Tensor))
    return out


class StepCounter(TorchDispatchMode):
    """Counts FLOPs, bytes moved and the peak of live intermediate bytes
    of the aten operations issued inside it (see the module docstring)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._formulas = flop_registry
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view:
            return out
        ins = _tensors((*args, *kwargs.values()))
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        self.ops += 1
        packet = func.overloadpacket
        if packet in self._formulas:
            self.flops += int(self._formulas[packet](*args, **kwargs,
                                                     out_val=out))
        elif packet.__name__ in _REDUCES:
            self.flops += max((a.numel() for a in ins), default=0)
        elif packet.__name__ not in _MOVES:
            self.flops += sum(o.numel() for o in outs if o.is_floating_point())
        alloc = packet.__name__ in _ALLOC
        self.bytes += sum(_nbytes(a) for a in ins)
        if not alloc:
            self.bytes += sum(_nbytes(o) for o in outs)
        mutated = func._schema.is_mutable
        for o in outs:
            if mutated or any(o is a for a in ins):
                continue
            n = o.untyped_storage().nbytes()
            self.live += n
            weakref.finalize(o, self._free, n)
        self.peak = max(self.peak, self.live)
        return out


def count(fn: Callable, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once under a ``StepCounter`` (pass
    ``meta`` tensors: nothing is computed) and return {"flops",
    "hbm_bytes", "peak_bytes", "ops"}."""
    with StepCounter() as c:
        fn(*args, **kwargs)
    return {"flops": float(c.flops), "hbm_bytes": float(c.bytes),
            "peak_bytes": int(c.peak), "ops": c.ops}


@dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    collective_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    bound: str

    def to_dict(self):
        return self.__dict__.copy()


def terms(flops: float, hbm_bytes: float, collective_bytes: float) -> Roofline:
    """The three roofline terms of one device's counts and the largest."""
    t = {"compute": flops / PEAK_FLOPS, "memory": hbm_bytes / HBM_BW,
         "collective": collective_bytes / LINK_BW}
    return Roofline(flops=flops, hbm_bytes=hbm_bytes,
                    collective_bytes=float(collective_bytes),
                    compute_s=t["compute"], memory_s=t["memory"],
                    collective_s=t["collective"], bound=max(t, key=t.get))


def analyze(fn: Callable, *args, collective_bytes: float = 0.0,
            chips: int = 1) -> Roofline:
    """The roofline of one step ``fn(*args)``: ``count`` on the given
    (``meta``) arguments, each term per device (the global counts over
    ``chips``; ``collective_bytes`` is per device already)."""
    c = count(fn, *args)
    return terms(c["flops"] / chips, c["hbm_bytes"] / chips, collective_bytes)


def collective_bytes(spec_tree: Mapping, shardings: Mapping, kind: str,
                     dtype: torch.dtype = torch.bfloat16) -> float:
    """Per-device parameter collectives of one step by plan (a lower
    bound; see the module docstring): each leaf of ``spec_tree`` held in
    ``dtype`` and sharded over g devices by its ``shardings`` leaf is
    all-gathered at bytes·(g−1)/g in the forward; a ``train`` step adds a
    second gather for the backward and an fp32 reduce-scatter of its
    gradient."""
    from repro_torch.models.module import leaves

    specs, shs = leaves(spec_tree), leaves(shardings)
    item = torch.empty((), dtype=dtype).element_size()
    total = 0.0
    for path, s in specs.items():
        n = math.prod(s.shape)
        g = n // max(1, math.prod(shs[path].shard_shape(s.shape)))
        if g <= 1:
            continue
        ring = (g - 1) / g
        total += n * item * ring
        if kind == "train":
            total += n * item * ring + n * 4 * ring
    return total


def model_flops(cfg, kind: str, seq_len: int, global_batch: int,
                n_chips: int) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference), N = params
    (active for MoE), D = tokens — per chip."""
    n_params = active_param_count(cfg)
    tokens = global_batch * (seq_len if kind != "decode" else 1)
    mult = 6 if kind == "train" else 2
    return mult * n_params * tokens / n_chips


def active_param_count(cfg) -> int:
    """Active (per-token) parameter count from the config."""
    d = cfg.d_model
    v = cfg.vocab_size
    emb = v * d * (1 if cfg.tie_embeddings else 2)
    if cfg.family == "ssm":
        s = cfg.ssm
        d_in = s.expand * d
        heads = d_in // s.head_dim
        conv_dim = d_in + 2 * s.n_groups * s.d_state
        per = d * (2 * d_in + 2 * s.n_groups * s.d_state + heads)
        per += s.d_conv * conv_dim + conv_dim + 3 * heads + d_in + d_in * d
        return emb + cfg.num_layers * per

    # attention
    dh = cfg.dh
    if cfg.mla:
        m = cfg.mla
        qk = m.qk_nope_dim + m.qk_rope_dim
        attn = d * cfg.num_heads * qk + d * m.kv_lora + d * m.qk_rope_dim
        attn += m.kv_lora * cfg.num_heads * (m.qk_nope_dim + m.v_dim)
        attn += cfg.num_heads * m.v_dim * d
    else:
        attn = d * dh * (cfg.num_heads + 2 * cfg.num_kv_heads) + cfg.num_heads * dh * d

    # channel mixer (active)
    if cfg.moe:
        mo = cfg.moe
        mlp = 3 * d * mo.d_expert * (mo.top_k + mo.num_shared)
    elif cfg.activation == "swiglu":
        mlp = 3 * d * cfg.d_ff
    else:
        mlp = 2 * d * cfg.d_ff

    if cfg.family == "hybrid":
        w = cfg.hybrid.lru_width or d
        rec = 2 * d * w + 2 * w * w + w * d + cfg.hybrid.d_conv * w
        pat = cfg.hybrid.pattern
        n_rec = sum(1 for p in pat if p == "rec")
        frac_rec = n_rec / len(pat)
        per = frac_rec * (rec + mlp) + (1 - frac_rec) * (attn + mlp)
        total = emb + cfg.num_layers * per
        return int(total)

    per = attn + mlp
    total = emb + cfg.num_layers * per
    if cfg.family == "audio":
        total += cfg.encdec.enc_layers * per + cfg.num_layers * attn  # cross-attn
    return int(total)
