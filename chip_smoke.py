#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:

1. the card (name, count, power limit) and the software versions;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` and print
   what ``-Xptxas -v`` reports;
3. each kernel against its plain PyTorch version at every main-path shape,
   B = 1 and B = 8, plus the kd = 144 / k = 18 shapes of the resolution
   ramp: DIGC indices equal except at near-ties, MRConv bit for bit;
4. serve ``vig_ti_iso`` at full width (224^2, D = 192, 12 blocks, 1000
   classes, seeded init) through ``VigServeEngine(digc_impl="cuda")`` on
   a ragged multi-tenant trace that uses buckets 1, 2, 4 and 8, each
   bucket's program captured as a CUDA graph on its first tick; check the
   launch counts, every request's logits bit for bit those of an eager
   forward of its bucket batch, and each layer's kernel output on the
   recorded features;
5. one batched ``vig_ti_pyr`` forward at 224^2 with the same checks,
   then both models, narrowed, against the reference tier end to end;
   the B = 8 forward's time (CUDA events, after a warm-up) and the DIGC
   and MRConv kernels' share of its device time (one profiled forward);
6. time each kernel with CUDA events beside its bound, its plain version
   and the PyTorch library calls that compute the same function, and
   profile one serving tick (device busy share, time by operator); the
   DIGC kernel's variants are timed at the same shapes. A DIGC row's
   bound takes the product at the rate its design uses (three TF32
   tensor-core products per fp32 product, or one bf16 product), printed
   beside the fp32 CUDA-core bound;
7. each DIGC variant against its plain version at every main-path shape:
   packed keys, bf16 operands and both together (B = 1 and 8), a
   ``grid_pos_bias`` positional bias, and the causal mask at the KNN
   attention shape (4 heads as the batch, S = 2048, D = 32, kd = 32);
8. serve ``vig_ti_iso`` at full width through the engine with
   ``DigcSpec(impl="cuda", packed=True, mxu_bf16=True)``, each layer's
   kernel call held against its plain version; then Algorithm 1 with a
   positional bias through the public ``digc()`` on each layer's features;
9. one full-width ``vig_ti_pyr`` forward (B = 8) through the ``blocked``
   tier, its logits beside the reference tier's;
10. ``knn_attention_mha`` at S = 2048, 4 heads, Dh = 32, 32 neighbours,
    ``impl="cuda"`` against ``impl="reference"``;
11. the DIGC kernel's legacy merge against its plain version at every
    main-path shape (B = 1 and 8): exact and packed, ``bucket_rounds``
    1 and 2 at each shape's largest block_m that is a multiple of kd
    within M rounded up to 128, and bf16, a positional bias and the
    causal mask at the KNN shape;
12. serve ``vig_ti_iso`` at full width through the tuned path: the
    config's ``blocked`` tier with ``autotune=True`` and a tuner cache in
    a temporary directory, on the phase-4 trace. Prints each bucket's
    ranked candidates, measured times and chosen schedule; the legacy
    merge must launch while tuning; a second engine on the same cache
    tunes nothing; ``retune_buckets()`` runs on the served histogram and
    ``buckets="auto"`` reads it back; then the trace through
    ``bucket_rounds=2``; last, the ``"cuda"`` engine constants of the
    cost model fitted to the blocked tier's measured times;
13. ``tune_schedule`` for full-width ``vig_ti_pyr`` (four stages, B = 8)
    and one forward through the tuned ``VigSchedule`` beside the
    reference tier;
14. the stateful engine on the ``cuda`` tier: the phase-4 trace, every
    request's logits bit for bit those of a stateless ``vig_forward`` of
    its tick's bucket batch, launch counts equal to phase 4's, the state
    rows unchanged, and requests/s in turns beside a stateless replay of
    the same bucket batches (the cost of the per-tick row copies);
15. stale-graph serving on the ``blocked`` tier, untuned: 8 video-like
    tenants x 8 frames (frame t + 1 = frame t + N(0, 0.001^2) pixel
    noise; pixels are N(0, 1)) plus one tenant whose every frame is a new image. Checks that
    ``reuse="tick", drift_tau=0.0`` serves logits bit for bit those of
    ``reuse=None``; runs ``tune_reuse`` at policy ``tick`` on the
    features of the first 3 ticks; serves the trace under ``tick``,
    ``layer`` and ``overlap`` at the tuned tau (the smallest swept tau
    when none is admitted) and prints, per policy, the reuse fraction,
    ``graph_reuses`` / ``graph_rebuilds``, the served-vs-fresh recall,
    the gate's host reads per tick and the median tick beside
    ``reuse=None``; the new-image tenant must rebuild on every tick;
16. parking: 6 tenants, each resending one frame (a still scene),
    cycling through 4 slots (``park_capacity=8``) on the phase-15 spec:
    parked tenants come back (``park_hits > 0``) and their next tick
    serves their cached graph (``graph_age > 0``);
    ``release()`` drops a parked copy and resets a bound slot;
17. faults on the card (``core.faults.FaultPlan``), full-width
    ``vig_ti_iso``, bucket 4, three tenants: on the ``cuda`` tier a
    non-finite image is quarantined while the co-batched lanes stay bit
    for bit the fault-free replay, a ``row_step`` bitflip is detected and
    served cold, a persistent ``program.build`` failure walks the ladder
    to ``blocked`` (logits equal a blocked forward of each bucket batch)
    and slow ticks over ``deadline_ms`` degrade after
    ``deadline_strikes`` misses; on ``blocked`` with ``reuse="tick"`` a
    NaN in ``graph_snap`` is quarantined and a lost parked copy
    re-admits cold. Prints each engine's fault counters and the guarded
    against the unguarded bucket-8 tick, in turns;
18. captured against eager (``EagerEngine``: the same engine with its
    programs run eagerly): the phase-4 trace's logits bit for bit and
    the launch counts equal, requests/s and the median tick by bucket in
    turns, a profiled bucket-8 tick of each (device busy share, host
    launch calls, device kernels; the DIGC and MRConv kernels the device
    ran equal the launch counters' rise, which a replay takes from its
    capture's tally of 12 / 12); then phase 15's trace per policy,
    captured bit for bit the eager engine with no gate read on a captured
    tick, and the median tick of each;
19. the (B, N) lattice: ``vig_ti_iso`` at full width through
    ``VigServeEngine(digc_impl="cuda", image_sizes=(160, 224, 448))``
    (N = 100, 196 and 784; at 448 k = 18 and dilations 2-6, kd 36-108)
    on ragged waves over buckets 1, 2, 4 and 8, tenants at two sizes, an
    eviction that parks several sizes' rows and a re-admission: every
    request's logits bit for bit an eager forward of its cell's batch, at
    most |buckets| x |sizes| captured programs, 12 DIGC and 12 MRConv
    launches a tick at every N, each cell's kernels against their plain
    versions on its recorded features; each cell's steady tick in turns,
    and the bucket-8 tick profiled at each size (busy share, host launch
    calls). Then 192^2 and 320^2 requests padded to the 224 and 448
    cells of a ``blocked`` engine, bit for bit a masked eager forward, no
    pad node in any top-k; then ``vig_ti_pyr`` at 192^2, 224^2 and 256^2 on the kernel
    tier (the positional embedding shrunk and grown);
20. SLO admission: ``arrival_trace(seed=0, tenants=8, classes=("gold",
    "default"), sizes=(224, 448))`` replayed on a ``VirtualClock`` with
    ``slo_ms={"gold": 20, "default": 80}`` on captured ``cuda``-tier
    programs (buckets 1, 2, 4: 8 tenants on 4 slots, so tenants park):
    every deadline held, each tenant served in order, ``padded_lanes`` the
    sum of (width - live), prefetch hits, logits bit for bit
    ``prefetch=False``, and ``slo_ms=0`` bit for bit the legacy engine;
    then the trace on the wall clock, ``slo_ms`` against ``slo_ms=0`` in
    turns: requests/s, padded lanes and admission-to-logits p50 / p99 per
    class (printed, not gated);
21. the approximate tiers, plain PyTorch (no kernel of their own):
    ``cluster_digc`` at B = 8, D = 192 and each main-path kd at N = 196
    and 784, on co-nodes built so that every distance is an exact integer,
    cold and per-row warm/cold, bit for bit the same function on the CPU;
    ``axial_digc`` at N = 196 against the CPU except at near-ties; each
    with its recall against the ``cuda`` kernel, device ms and device
    operations / host launch calls per call beside the kernel's; per
    layer recall of a B = 8 forward of each tier against the kernel;
    then ``VigServeEngine(digc_impl="cluster")`` on the phase-4 trace
    (two passes) and on (tenant, size) waves over 224^2 and 448^2,
    captured bit for bit an ``EagerEngine`` (logits and centroids), warm
    rows at both sizes, no DIGC or MRConv kernel launched; the steady
    captured bucket-8 tick of a cluster and a cuda engine in turns and
    profiled (device busy, host launch calls); last, a centroid bitflip
    served cold with the co-batched lanes bit for bit the fault-free run
    and a persistent cluster build failure walking the ladder to
    ``blocked``;
22. LM serving (no kernel of its own: dense attention is plain PyTorch,
    KNN attention's prefill the ``blocked`` DIGC tier, its decode a sort):
    (a) ``olmo-1b`` at full width (16 layers, d_model 2048, vocab 50304,
    bf16 compute, seeded init on the card) served through
    ``repro_torch.launch.serve.main`` with its defaults (8 requests, 16
    prompt and 16 new tokens, 4 slots): every token in range, every
    logit finite; tokens/s, the decode step's time by CUDA events, its
    host launch calls and device busy share from the profiler, and its
    bound (the bf16 weights and the cache read once); (b) a ``slots=1``
    engine bit for bit a direct ``decode_step`` greedy loop; in fp32 at
    full width ``prefill`` + one ``decode_step`` against ``forward``
    (rtol 2e-3, atol 2e-4); at 2 layers, full width, fp32 the card's
    greedy decode logits against the CPU's (max |diff| within 1e-2 of the
    logits' RMS) with equal tokens; (c) ``attention="knn"`` with 64 neighbours: 4 requests of 256
    prompt tokens and 16 new ones, then one ``prefill`` of 1024 tokens
    timed, its DIGC calls counted, no kernel launched;
23. the MoE family (plain PyTorch, no kernel of its own: JAX's MoE and MLA
    are einsums and ``lax.top_k``): ``deepseek-v2-lite-16b`` at full width
    (27 layers, d_model 2048, 16 heads, MLA kv_lora 512, qk 128 + 64, v
    128; 64 experts top-6 of d_expert 1408 and 2 shared; vocab 102400;
    bf16, 16.21 B parameters drawn on the card straight into the compute
    dtypes) through ``launch.serve.main``'s defaults: every token in
    range, every logit finite, no kernel launched; tokens/s, decode
    calls, the parameters' count and bytes, the peak memory allocated;
    the decode step at 4 slots by CUDA events and profiled, beside two
    bounds: the dense form's (every expert read) and a routed form's (the
    experts this step's tokens select); a ``slots=1`` engine bit for bit
    the direct greedy loop (tokens, ``c_kv`` and ``k_pe``); then, the bf16
    engine freed, fp32 ``prefill`` + ``decode_step`` against ``forward``
    at 4 layers (rtol 2e-3, atol 2e-4) and the card against the CPU at 2
    layers (tokens equal, logits within ``LM_TOL_RMS``); last,
    ``qwen3-moe-235b-a22b`` at full width and 2 layers (128 experts top-8,
    GQA with qk-norm): a short served run with finite logits, its step;
24. the recurrent families (plain PyTorch, no kernel of their own: JAX's
    SSD and RG-LRU are einsums, ``cumsum`` and scans): ``mamba2-370m`` (48
    SSD layers, d_model 1024, d_state 128, vocab 50280) and then, its
    engine freed, ``recurrentgemma-9b`` (38 layers = 12 (rec, rec, attn)
    groups + 2 ``rem`` RG-LRU layers, d_model 4096, local window 2048,
    vocab 256000), each at full width in bf16 through
    ``launch.serve.main``'s defaults: every token in range, every logit
    finite, no kernel launched; tokens/s, the peak memory; the decode step
    at 4 slots by CUDA events and profiled against its bound (the weights
    read once, each slot's recurrent state read and written, the
    attention cache read once); a ``slots=1`` engine bit for bit the direct
    greedy loop (tokens and every cache leaf: ``h``, ``conv``, the
    hybrid's ``k`` / ``v``); fp32 the decode loop against ``forward`` (4
    layers of the SSM, with ``prefill`` + one decode too; 2 ``rem``
    layers of the hybrid, whose prefill cache cannot be decoded, as
    JAX's) and the card against the CPU at 2 layers (tokens equal, logits
    within ``RECURRENT_TOL_RMS``); last the hybrid's 4-layer fp32 drift
    (one group: the decode loop against ``forward``, measured, finite);
25. the encoder-decoder (plain PyTorch, no kernel of its own: JAX's
    encoder-decoder is einsums and softmaxes): ``whisper-tiny`` at full
    width (4 encoder and 4 decoder layers, d_model 384, 6 heads of 64,
    vocab 51865, ``dec_pos`` of 65536 rows, bf16, seeded init) through
    ``get_api``: 4 requests of 1500 seeded frames and a 4-token prompt,
    ``prefill_fn`` filling a cache from ``init_cache(4, max_len=68,
    enc_len=1500)``, then 64 greedy ``decode_fn`` steps: every token in
    range, every logit finite, no kernel launched, tokens/s, the peak
    memory; the decode step by CUDA events and profiled against its bound
    (the decoder's and embedding's weights and the memory's ``mk`` /
    ``mv`` read once); in fp32 at full width every greedy token the argmax
    of teacher-forced ``decode_forward`` over the generated prefix (or a
    near-tie there) and the median position's logits within
    ``LM_TOL_RMS`` of their RMS, the positions beyond it counted and the
    largest gap printed (the reference's init makes the attention
    one-hot, so an fp32 near-tie between keys moves a position's logits
    by 10-30%, in JAX too); at 2 + 2 layers the card's decoder on the
    CPU's encoder memory, fed the CPU's greedy tokens, against the CPU,
    held the same way, and the two devices' memories' gap printed (at
    1500 frames the reference's own encoder moves that far under a
    one-ulp change of its input);
26. training (no kernel launched but in (c)'s serving): (a) ``olmo-1b``
    at full width (remat full, bf16 params, fp32 master) through
    ``launch.train.main --batch 8 --seq 128 --steps 34 --ckpt-every 15``
    into a temporary directory: every loss finite, the last fifth's mean
    below the first fifth's, the steady step by CUDA events, the peak
    memory; a second ``main`` on the directory resumes at step 30, the
    restored tree (params and ``OptState``) holds the saved values bit
    for bit, and its losses equal the first run's steps 30-33 within 1e-3
    relative (bit for bit where printed); then one step split by CUDA
    events into forward, backward, recompute and optimizer, each beside
    its bound, and profiled (busy share); (b) one train step of
    ``whisper-tiny`` (8 x 1500 frames, 128 decoder tokens) and of
    ``mamba2-370m`` (8 x 128) at full width: loss and grad norm finite,
    the norm > 0, the params changed; one fp32 step per family (dense,
    vlm, moe, ssm, hybrid, audio) at SMOKE width and 2 layers on the card
    and on the CPU: loss and grad norm within 1e-4 relative (the grad
    norm within 1e-2 for the hybrid and audio archs, whose SMOKE init
    leaves fp32 ill-conditioned); (c) ``vig_ti_iso`` at full width (224²,
    1000 classes, B = 8, ``blocked``) through ``launch.train_vig.main
    --full`` for 30 steps: the loss finite and falling, the steady step,
    the peak memory; ``--digc-impl cuda`` fails at its first step (the
    MRConv kernel has no backward); the trained weights served through
    ``VigServeEngine(digc_impl="cuda")`` on phase 4's trace, each request
    bit for bit the eager forward of its bucket batch, both kernels
    launched once a block a tick, each layer's neighbour lists against
    the ``blocked`` tier's on the recorded features (equal but at fp32
    near-ties; the fraction printed) and the logit gap to the ``blocked``
    forward printed.

Each path of phases 4, 5, 8, 10, 12, 14 and 19 runs with the launch counts
set to 0 just before it and read just after; a kernel or variant of that
path with no launch fails the run (phases 9, 15 and 16 run the blocked
tier, which must launch none; so do phase 21's cluster engines, the LM
phases 22, 23 and 24, and phases 25 and 26's runs but the served trained
weights, which must launch both kernels). A
replayed graph adds the launches its capture recorded. Every engine
outside phases 17 and 21 (c) must end with
``fallback_level`` 0 and no logged fault. The line before the last is the kernel summary
as JSON (one entry per kernel and DIGC variant); the last line is
``{"ok": true, "device": {...}}``. Without a card it exits non-zero and
prints no result.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import testing  # noqa: E402
from repro_torch.core import DigcSpec, DigcTuner, digc, grid_pos_bias  # noqa: E402
from repro_torch.core import perfmodel, prng, strategies  # noqa: E402
from repro_torch.core.tuner import LEGACY_TILES, time_calls  # noqa: E402
from repro_torch.core.digc import drift_stat  # noqa: E402
from repro_torch.core.knn_attention import knn_attention_mha  # noqa: E402
from repro_torch.core.tuner import tune_reuse  # noqa: E402
from repro_torch.core.builder import degraded_spec  # noqa: E402
from repro_torch.core.faults import FaultPlan  # noqa: E402
from repro_torch.core.packedkey import idx_bits_for  # noqa: E402
from repro_torch.kernels import _build, launch_counts, ops, reset_launch_counts  # noqa: E402
from repro_torch.kernels.digc_topk import BIG, digc_topk_cuda, digc_topk_plain  # noqa: E402
from repro_torch.kernels.mrconv import mrconv_cuda, mrconv_plain  # noqa: E402
from repro_torch.models import convert, vig  # noqa: E402
from repro_torch.serve.engine import VigRequest, VigServeEngine  # noqa: E402
from repro_torch import configs as lm_configs  # noqa: E402
from repro_torch.core import knn_attention  # noqa: E402
from repro_torch.launch import serve as lm_serve  # noqa: E402
from repro_torch.models import module, moe, transformer as tr  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.sched import VirtualClock, arrival_trace, replay  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.core.digc import digc_blocked  # noqa: E402
from repro_torch.data.pipeline import DataConfig, synth_lm_batch  # noqa: E402
from repro_torch.launch import train as lm_train, train_vig  # noqa: E402
from repro_torch.launch.api import get_api  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.train import optimizer  # noqa: E402
from repro_torch.train.trainer import init_train_state, make_train_step, value_and_grad  # noqa: E402

# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, dense TF32
# and bf16 on the tensor cores, HBM3 rate.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# Distances are fp32 sums taken in two orders (the kernel's FMA chain vs
# cuBLAS), and (|x|^2 - 2 x.y) + |y|^2 cancels: the rounding scales with
# the squared norms, not with the distance. Tolerance: ATOL + RTOL * (the
# largest |x|^2 + the largest |y|^2) absolute, RTOL relative.
RTOL, ATOL = 1e-5, 1e-4
DEV = torch.device("cuda", 0)
SLEEP_CYCLES_PER_MS = 1.0e6  # set by calibrate_sleep()

DIGC_SOURCE = {
    "route": "cuda",
    "source": "src/repro_torch/kernels/csrc/digc_topk.cu",
    "replaces": "src/repro/kernels/digc_topk.py:394",
}
KERNELS = {
    "digc_topk": DIGC_SOURCE,
    "digc_topk.packed": DIGC_SOURCE,
    "digc_topk.mxu_bf16": DIGC_SOURCE,
    "digc_topk.pos_bias": DIGC_SOURCE,
    "digc_topk.causal": DIGC_SOURCE,
    "digc_topk.legacy": DIGC_SOURCE,
    "digc_topk.bucket_rounds": DIGC_SOURCE,
    "mrconv": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mrconv.cu",
        "replaces": "src/repro/kernels/mrconv.py:82",
    },
}


# Variant keywords of digc_topk_cuda / digc_topk_plain timed and checked.
PACKED_BF16 = {"packed": dict(packed=True), "mxu_bf16": dict(mxu_bf16=True),
               "packed+mxu_bf16": dict(packed=True, mxu_bf16=True)}
# KNN attention: heads (the DIGC batch), sequence, head width, neighbours.
KNN = dict(heads=4, seq=2048, dh=32, nn=32)
# Scale of the positional bias (grid coordinates in [0, 1]): distances at
# the iso shape are a few hundred, so the bias reorders neighbours.
POS_SCALE = 100.0


class EagerEngine(VigServeEngine):
    """The engine with its bucket programs run eagerly on the card, as on
    the CPU: what the captured programs are held against."""

    def _captures(self) -> bool:
        return False


def phase(title: str) -> None:
    print(f"\n=== {title}", flush=True)


def fired(counts: dict) -> dict:
    """The launch counts that are not zero."""
    return {k: v for k, v in counts.items() if v}


def main_path_shapes(*names: str) -> tuple[set, set]:
    """(N, M, D, kd) DIGC shapes and (N, M, D, k) MRConv shapes of the
    models' forwards at their native grids, from their stage plans."""
    digc, mr = set(), set()
    for name in names:
        cfg = vig.VIG_VARIANTS[name]
        for plan in vig.vig_stage_plans(cfg, "cuda"):
            d = cfg.embed_dims[plan.index]
            for dil, k in zip(plan.dilations, plan.k_effs):
                digc.add((plan.n, plan.m, d, k * dil))
                mr.add((plan.n, plan.m, d, k))
    return digc, mr


def to_dev(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(DEV)


def check_digc(x, y, kd: int, pos_bias=None, **variant) -> tuple[float, int]:
    """Kernel vs plain on one input; returns the largest distance error on
    live lanes and the number of near-tie swaps (entries whose indices
    differ). Packed keys keep 32 - idx_bits bits of each distance, which
    adds a relative 2**(idx_bits - 23) to the tolerance. BIG lanes
    (causal) must be equal, index included, and every index in [0, M)."""
    dist, idx = digc_topk_cuda(x, y, kd, pos_bias, **variant)
    ref_d, ref_i = digc_topk_plain(x, y, kd, pos_bias, **variant)
    in_range = (idx >= 0) & (idx < y.shape[1])
    rtol = RTOL + (2.0 ** (idx_bits_for(y.shape[1]) - 23)
                   if variant.get("packed") else 0.0)
    scale = float(x.square().sum(-1).max() + y.square().sum(-1).max())
    if pos_bias is not None:
        scale += float(pos_bias.abs().max())
    torch.cuda.synchronize()
    live = ref_d < BIG / 2
    if not (torch.equal(dist < BIG / 2, live) and torch.equal(idx[~live], ref_i[~live])
            and torch.equal(dist[~live], ref_d[~live])):
        raise AssertionError(f"BIG lanes differ from the plain version ({variant})")
    if variant.get("kernel_merge") == "legacy" or variant.get("bucket_rounds"):
        in_range |= ~live  # the legacy merge's pad columns alias past M
    if not in_range.all():
        raise AssertionError(f"an index outside [0, M) ({variant})")
    fill = -1 - torch.arange(kd, dtype=idx.dtype, device=idx.device)  # distinct
    testing.assert_topk_match(torch.where(live, idx, fill).cpu().numpy(),
                              torch.where(live, dist, 0).cpu().numpy(),
                              torch.where(live, ref_i, fill).cpu().numpy(),
                              torch.where(live, ref_d, 0).cpu().numpy(),
                              rtol=rtol, atol=ATOL + rtol * scale)
    return (float((dist - ref_d).abs()[live].max()),
            int((idx != ref_i).sum()))


def check_mrconv(x, y, idx) -> None:
    out = mrconv_cuda(x, y, idx)
    ref = mrconv_plain(x, y, idx)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise AssertionError(
            f"mrconv differs from its plain version by "
            f"{float((out - ref).abs().max())} at {tuple(x.shape)}, k={idx.shape[-1]}")


def check_layers(capture: list, plans, **variant) -> float:
    """Each captured DIGC call's kernels against the plain versions on the
    features the model fed them; returns the largest distance error."""
    geo = [(d, k) for p in plans for d, k in zip(p.dilations, p.k_effs)]
    if len(capture) != len(geo):
        raise AssertionError(f"{len(capture)} DIGC calls for {len(geo)} blocks")
    worst, swaps = 0.0, []
    for (key, h, cond), (dil, k) in zip(capture, geo):
        y = h if cond is None else cond
        kd = k * dil
        err, n_swaps = check_digc(h, y, kd, **variant)
        worst = max(worst, err)
        swaps.append(n_swaps)
        idx = digc_topk_cuda(h, y, kd, **variant)[1][..., ::dil].contiguous()
        check_mrconv(h, y, idx)
    print(f"{len(geo)} layers: kernels equal their plain versions on the "
          f"captured features (max |dist err| {worst:.3g}; near-tie swaps "
          f"per layer {swaps})")
    return worst


def _events_ms(fn, iters: int, hold_ms: float = 0.0) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if hold_ms:
        torch.cuda._sleep(int(hold_ms * SLEEP_CYCLES_PER_MS))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_ms(fn, iters: int = 50, warmup: int = 5) -> tuple[float, float]:
    """(device ms, call ms) of one call, by CUDA events around ``iters``
    calls. Call time: the calls as a Python caller issues them, so the
    host's launch cost can pace the device. Device time: the same calls
    queued behind a device-side sleep longer than the host needs to
    issue them, so they run back to back."""
    for _ in range(warmup):
        fn()
    call = _events_ms(fn, iters)
    return _events_ms(fn, iters, hold_ms=2.0 * call * iters + 1.0), call


def calibrate_sleep() -> None:
    """Cycles of ``torch.cuda._sleep`` per millisecond on this card."""
    global SLEEP_CYCLES_PER_MS
    cycles = 10_000_000
    ms = _events_ms(lambda: torch.cuda._sleep(cycles), 3)
    SLEEP_CYCLES_PER_MS = cycles / ms


def bound(flops: float, nbytes: float,
          peak_flops: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def card_and_software() -> tuple[str, str]:
    phase("1. card and software")
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs only on a card", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    name = torch.cuda.get_device_name(0)
    print(f"card 0: {name}; cards: {torch.cuda.device_count()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc {nvcc.strip().splitlines()[-1]}, python {sys.version.split()[0]}")
    # fp32 everywhere: the dense layers' matmuls and any convolution.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("allow_tf32: matmul False, cudnn False")
    return name, smi


def build() -> None:
    phase("2. build")
    lib = _build.load()
    print(f"built {lib.path.name} in {lib.build_seconds:.2f} s")
    for src, report in lib.ptxas.items():
        for line in report.splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                print(f"  {src}: {line.strip()}")


def kernels_vs_plain() -> float:
    phase("3. kernels against their plain versions")
    digc, mr = main_path_shapes("vig_ti_iso", "vig_ti_pyr")
    digc.add((196, 196, 192, 144))  # the resolution ramp: k = 18, d = 8
    mr.add((196, 196, 192, 18))
    worst = 0.0
    for b in (1, 8):
        for n, m, d, kd in sorted(digc):
            x = to_dev(testing.features(n + kd, b, n, d))
            y = to_dev(testing.features(m + d, b, m, d))
            err, swaps = check_digc(x, y, kd)
            worst = max(worst, err)
            print(f"digc_topk B={b} N={n} M={m} D={d} kd={kd}: ok "
                  f"(max |dist err| {err:.3g}, near-tie swaps {swaps})")
        for n, m, d, k in sorted(mr):
            x = to_dev(testing.features(n, b, n, d))
            y = to_dev(testing.features(m, b, m, d))
            idx = to_dev(testing.neighbour_ids(k, b, n, k, m))
            check_mrconv(x, y, idx)
            print(f"mrconv    B={b} N={n} M={m} D={d} k={k}: bitwise equal")
    return worst


def trace_ticks() -> list:
    """Ticks of (uid, tenant) arrivals: 20 requests from 10 tenants plus a
    one-shot, in tick sizes 8, 3, 2, 1, 5, 1 (buckets 8, 4, 2, 1, 8, 1)."""
    ticks = [[(i, f"t{i}") for i in range(8)],
             [(8, "t0"), (9, "t1"), (10, "t2")],
             [(11, "t3"), (12, "t8")],
             [(13, "t4")],
             [(14, "t0"), (15, "t1"), (16, "t5"), (17, "t6"), (18, None)],
             [(19, "t9")]]
    assert sum(map(len, ticks)) == 20
    return ticks


def serve_trace(eng, images, batches=None) -> tuple[list, dict, float]:
    """The phase-4 trace through ``eng``: its requests, host-clock ms per
    tick by bucket and the seconds it took. ``batches`` (a list) collects
    each tick's requests in slot order and its bucket."""
    lat: dict[int, list] = {}
    reqs = []
    t0 = time.perf_counter()
    for tick in trace_ticks():
        tick_reqs = [VigRequest(uid, images[uid], tenant=tenant)
                     for uid, tenant in tick]
        for req in tick_reqs:
            eng.submit(req)
        reqs += tick_reqs
        s = time.perf_counter()
        eng.step()  # returns after the logits reach the host
        lat.setdefault(eng.last_bucket, []).append((time.perf_counter() - s) * 1e3)
        if batches is not None:
            batches.append(bucket_batch(eng, tick_reqs))
    return reqs, lat, time.perf_counter() - t0


def assert_no_faults(eng, what: str) -> None:
    """Outside phase 17 no path may descend the degradation ladder or log
    a fault: the ladder must never hide a broken kernel."""
    if eng.fallback_level or eng.fault_log:
        raise AssertionError(
            f"{what}: fallback_level {eng.fallback_level}, faults "
            f"{[f.as_dict() for f in eng.fault_log]}")


def check_bucket_forwards(params, cfg, digc_impl, batches) -> None:
    """Every served request's logits bit for bit those of an eager
    stateless ``vig_forward`` of its tick's bucket batch: the captured
    programs (and the stateful engine around them) change no bit."""
    with torch.inference_mode():
        for order, bucket in batches:
            ref = vig.vig_forward(params, to_dev(stack_batch(order, bucket)),
                                  cfg, digc_impl=digc_impl).cpu().numpy()
            for i, r in enumerate(order):
                if not np.array_equal(r.logits, ref[i]):
                    raise AssertionError(
                        f"request {r.uid}: logits differ from the eager "
                        f"forward of its bucket batch by "
                        f"{float(np.abs(r.logits - ref[i]).max())}")


def serve_iso(title: str, digc_impl, variant: dict):
    """Serve full-width vig_ti_iso through the engine on the phase-4 trace
    with the launch counts set to 0 just before the timed pass; check the
    counts (every DIGC launch with ``variant`` on), the logits and each
    layer's kernels on the first tick's images. Returns (engine, images,
    counts of the timed pass, requests served, per-layer features, the
    largest distance error)."""
    phase(title)
    cfg = vig.VIG_VARIANTS["vig_ti_iso"]
    params = convert.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                 device=DEV)
    images = [testing.images(uid, 1, cfg.image_size)[0] for uid in range(20)]
    eng = VigServeEngine(cfg, params, digc_impl=digc_impl, device=DEV)
    serve_trace(eng, images)  # warm-up pass: first use of each bucket
    ticks = len(trace_ticks())
    reset_launch_counts()
    batches: list = []
    reqs, lat, seconds = serve_trace(eng, images, batches)
    counts = launch_counts()
    stats = eng.stats()
    print(f"stats: {json.dumps(stats)}")
    assert_no_faults(eng, title)
    if stats["compile_count"] != 4 or sorted(eng._captured) != [1, 2, 4, 8]:
        raise AssertionError(f"{stats['compile_count']} captured programs "
                             f"for 4 buckets: {sorted(eng._captured)}")
    if sorted(stats["bucket_ticks"]) != [1, 2, 4, 8]:
        raise AssertionError(f"buckets used: {stats['bucket_ticks']}")
    want = 12 * ticks
    expect = {"digc_topk": want, "mrconv": want,
              **{f"digc_topk.{v}": want for v in variant}}
    if fired(counts) != expect:
        raise AssertionError(f"launches {counts}, expected {expect}")
    logits = np.stack([r.logits for r in reqs])
    if logits.shape != (20, 1000) or not np.isfinite(logits).all():
        raise AssertionError(f"logits {logits.shape} not finite")
    print(f"launches in the timed pass: {fired(counts)} over {ticks} ticks, "
          f"{len(reqs)} requests; per request "
          f"{ {k: v / len(reqs) for k, v in fired(counts).items()} }")
    rps = len(reqs) / seconds
    print(f"requests/s: {rps:.2f} ({seconds * 1e3:.1f} ms for "
          f"{len(reqs)} requests)")
    for b in sorted(lat):
        print(f"bucket {b}: median tick {statistics.median(lat[b]):.2f} ms "
              f"over {len(lat[b])} ticks")
    check_bucket_forwards(params, cfg, digc_impl, batches)
    print(f"captured programs: every request's logits bit for bit those of "
          f"an eager forward of its bucket batch ({len(batches)} ticks)")
    # Per-layer kernel checks and the logits against the plain reference
    # tier, on the first tick's eight images.
    batch = torch.from_numpy(np.stack(images[:8])).to(DEV)
    capture: list = []
    with torch.inference_mode():
        out = vig.vig_forward(params, batch, cfg, digc_impl=digc_impl,
                              digc_capture=capture)
        ref = vig.vig_forward(params, batch, cfg, digc_impl="reference")
    worst = check_layers(capture, vig.vig_stage_plans(cfg, digc_impl), **variant)
    check_logits(out, ref, logits[:8])
    return eng, images, counts, len(reqs), capture, worst, rps


def serving() -> tuple[dict, dict, float]:
    eng, images, counts, served, _, _, rps = serve_iso(
        "4. serving vig_ti_iso at full width", "cuda", {})
    profile_tick(eng, images)
    return counts, {k: v / served for k, v in counts.items()}, rps


def profile_tick(eng, images, tag: str = "p") -> dict:
    """One bucket-8 tick of eight new tenants (``tag`` + 0..7) under
    torch.profiler: the device's busy share of the tick, the host's
    launch calls (runtime API calls named ``cuda*Launch*``: kernels, and
    a captured program's one graph launch), the kernels the device ran,
    and the operators that take the device's and the host's time.

    Returns, beside the times, the launch counters' rise over the tick
    (``counted``: a replay's comes from its capture's tally) and the DIGC
    and MRConv kernels the profiler saw the device run (``on_device``)."""
    from torch.profiler import ProfilerActivity, profile

    before = launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for uid in range(8):
            eng.submit(VigRequest(100 + uid, images[uid], tenant=f"{tag}{uid}"))
        eng.step()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0)

    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    calls = {e.key: e.count for e in events
             if not str(e.device_type).endswith("CUDA")
             and e.key.startswith("cuda") and "Launch" in e.key}
    ran = sum(e.count for e in kernels)
    after = launch_counts()
    counted = {k: after[k] - before[k] for k in ("digc_topk", "mrconv")}
    on_device = {k: sum(e.count for e in kernels if f"{k}_kernel" in e.key)
                 for k in counted}
    print(f"profiled tick (bucket {eng.last_bucket}): {wall_ms:.2f} ms on the "
          f"host clock under the profiler, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%); host launch calls "
          f"{sum(calls.values())} {calls}; device kernels {ran}; DIGC and "
          f"MRConv counted {counted}, on the device {on_device}")
    for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
        print(f"  device {dev_us(e) / 1e3:8.3f} ms x{e.count:<4d} {e.key[:70]}")
    cpu = [e for e in events if not str(e.device_type).endswith("CUDA")]
    for e in sorted(cpu, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]:
        print(f"  host   {e.self_cpu_time_total / 1e3:8.3f} ms x{e.count:<4d} "
              f"{e.key[:70]}")
    assert_no_faults(eng, "profiled tick")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                host_launches=sum(calls.values()), kernels=ran,
                counted=counted, on_device=on_device)


def check_logits(out, ref, served=None) -> None:
    """Finite logits; served ones equal the batched forward's. The gap to
    the plain reference tier is printed, not held to a tolerance: at full
    width the first layers' top-k lists hold neighbours one fp32 ulp
    apart, the kernel and cuBLAS round them apart (the near-tie swaps
    above), and each swap changes the next layer's features. The
    end-to-end tolerance is held on small inputs (``small_forwards``)."""
    out, ref = out.float().cpu().numpy(), ref.float().cpu().numpy()
    if not np.isfinite(out).all():
        raise AssertionError("non-finite logits")
    scale = max(1.0, float(np.abs(ref).max()))
    print(f"logits vs plain reference tier: max |diff| "
          f"{float(np.abs(out - ref).max()):.3g} (largest logit {scale:.3g})")
    if served is not None and not np.allclose(served, out, rtol=0,
                                              atol=1e-5 * scale):
        raise AssertionError("served logits differ from the batched forward")


def small_forwards() -> None:
    """The cuda path against the plain reference tier end to end, within
    1e-4 of the largest logit, on the small models of the CPU tests
    (tests/test_torch_vig.py), where no near-tie flips a neighbour."""
    cases = [("vig_ti_iso", dict(image_size=96, embed_dims=(32,), depths=(6,),
                                 k=4, num_classes=10)),
             ("vig_ti_pyr", dict(image_size=64, embed_dims=(8, 16, 24, 32),
                                 depths=(1, 1, 1, 1), num_classes=10))]
    for name, kw in cases:
        cfg = vig.VIG_VARIANTS[name].replace(**kw)
        params = convert.init_params(
            cfg, generator=torch.Generator().manual_seed(2), device=DEV)
        batch = to_dev(testing.images(7, 2, cfg.image_size))
        with torch.inference_mode():
            out = vig.vig_forward(params, batch, cfg, digc_impl="cuda")
            ref = vig.vig_forward(params, batch, cfg, digc_impl="reference")
        diff = float((out - ref).abs().max())
        scale = max(1.0, float(ref.abs().max()))
        print(f"small {name}: logits vs reference tier max |diff| {diff:.3g}")
        if diff > 1e-4 * scale:
            raise AssertionError(f"small {name}: logits differ by {diff}")


def pyramid() -> None:
    phase("5. vig_ti_pyr forward at 224^2, B = 8")
    cfg = vig.VIG_VARIANTS["vig_ti_pyr"]
    params = convert.init_params(cfg, generator=torch.Generator().manual_seed(1),
                                 device=DEV)
    batch = to_dev(testing.images(100, 8, cfg.image_size))
    plans = vig.vig_stage_plans(cfg, "cuda")
    capture: list = []
    reset_launch_counts()
    with torch.inference_mode():
        out = vig.vig_forward(params, batch, cfg, digc_impl="cuda",
                              digc_capture=capture)
    torch.cuda.synchronize()
    counts = launch_counts()
    blocks = sum(cfg.depths)
    if fired(counts) != {"digc_topk": blocks, "mrconv": blocks}:
        raise AssertionError(f"launches {counts}, expected {blocks} of each")
    print(f"launches: {fired(counts)}; stage (N, M): "
          f"{[(p.n, p.m) for p in plans]}")
    with torch.inference_mode():
        ref = vig.vig_forward(params, batch, cfg, digc_impl="reference")
    check_logits(out, ref)
    check_layers(capture, plans)
    small_forwards()
    forward_time(params, batch, cfg)


def forward_time(params, batch, cfg) -> dict:
    """The B = 8 forward through the ``cuda`` tier: CUDA events around
    five forwards as Python issues them, after two of warm-up (so the
    host's launch pace is in this time), then one forward under
    torch.profiler for its device time (the sum over its kernels) and
    the DIGC and MRConv kernels' share of it."""
    from torch.profiler import ProfilerActivity, profile

    def forward():
        return vig.vig_forward(params, batch, cfg, digc_impl="cuda")

    with torch.inference_mode():
        for _ in range(2):
            forward()
        ms = _events_ms(forward, 5)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            forward()
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    total = sum(e.self_device_time_total for e in kernels)
    digc_us = sum(e.self_device_time_total for e in kernels
                  if "digc_topk_kernel" in e.key or "digc_legacy_kernel" in e.key)
    mr_us = sum(e.self_device_time_total for e in kernels
                if "mrconv_kernel" in e.key)
    if total <= 0 or digc_us <= 0 or mr_us <= 0:
        raise AssertionError("the profiler saw no device time for the kernels")
    print(f"B = 8 forward (cuda tier): {ms:.3f} ms a forward by CUDA events "
          f"as Python issues them; profiled forward's device time "
          f"{total / 1e3:.3f} ms: DIGC kernels {digc_us / 1e3:.3f} ms "
          f"({100 * digc_us / total:.1f}%), MRConv {mr_us / 1e3:.3f} ms "
          f"({100 * mr_us / total:.1f}%)")
    return dict(ms=ms, device_ms=total / 1e3,
                digc_ms=digc_us / 1e3, mrconv_ms=mr_us / 1e3)


def stage_pos_bias(n: int, m: int) -> torch.Tensor:
    """(1, N, M) positional bias between a stage's node grid and its
    co-node grid, shared by the batch."""
    g, gc = int(round(n ** 0.5)), int(round(m ** 0.5))
    return grid_pos_bias(g, g, gc, gc, scale=POS_SCALE, device=DEV)[None]


# The bucket_rounds spec phase 12 serves: block_m 216 is a multiple of
# every kd of vig_ti_iso (9, 18, 27).
BUCKET_SPEC = dict(packed=True, bucket_rounds=2, block_m=216)


def bucket_tiles(m: int, kd: int) -> tuple[int, int | None]:
    """bucket_rounds block_m values at one shape: the largest multiple of
    kd within M rounded up to 128, and the served spec's (``BUCKET_SPEC``,
    clamped as the wrapper clamps it) where it has kd buckets of two or
    more columns, else None."""
    top = -(-m // 128) * 128
    served = min(BUCKET_SPEC["block_m"], top)
    return top // kd * kd, (served if served % kd == 0 and served >= 2 * kd
                            else None)


def resolved_block_m(n: int, m: int, d: int, kd: int, kw: dict) -> int:
    """The block_m a kernel call with keywords ``kw`` runs at."""
    tiles = {a: kw[a] for a in ("block_n", "block_m", "packed",
                                "bucket_rounds", "kernel_merge") if a in kw}
    return ops.resolve_kernel_args(n, m, d, kd, **tiles)[1]


def legacy_cases(n: int, m: int, d: int, kd: int) -> list:
    """(name, kernel keywords) of every legacy-merge tile the main path
    runs at one shape: exact and packed at the JAX default block_m and at
    each tile the tuner offers (``LEGACY_TILES``); bucket_rounds r = 1 and
    2 at the largest block_m of ``bucket_tiles`` and at the served one.
    Calls that resolve to the same tiles are checked once."""
    cases: dict = {}
    for bn, bm in ((None, None),) + LEGACY_TILES:
        for packed in (False, True):
            kw = dict(kernel_merge="legacy", packed=packed, block_n=bn,
                      block_m=bm)
            key = (packed, 0, resolved_block_m(n, m, d, kd, kw))
            cases.setdefault(key, ("legacy+packed" if packed else "legacy", kw))
    for bm in filter(None, bucket_tiles(m, kd)):
        for r in (1, 2):
            cases.setdefault((True, r, bm), (
                f"bucket_rounds={r}",
                dict(packed=True, bucket_rounds=r, block_m=bm)))
    return list(cases.values())


def timed_legacy(m: int, kd: int) -> dict:
    """Phase 6's legacy rows at one shape: exact and packed at the JAX
    default block_m, bucket_rounds at the served block_m (the largest one
    where kd does not divide it)."""
    top, served = bucket_tiles(m, kd)
    return {"legacy": dict(kernel_merge="legacy"),
            "legacy+packed": dict(kernel_merge="legacy", packed=True),
            "bucket_rounds": dict(BUCKET_SPEC, block_m=served or top)}


def knn_inputs() -> tuple:
    """Queries, keys and values (S, H, Dh) of the KNN attention phases."""
    return tuple(to_dev(testing.features(i, KNN["seq"], KNN["heads"], KNN["dh"]))
                 for i in (11, 12, 13))


def digc_row(b, n, m, d, kd, fn, plain, *, pairs=None, pos=False, bf16=False,
             library=None) -> dict:
    """Kernel, call, plain and library times beside the bound: each input
    read once (x, y fp32; a shared (N, M) bias), each output written once;
    2 D operations per (row, column) pair the run needs (all of them, or
    the causal triangle), at the rate the kernel's design takes them:
    three TF32 tensor-core products per fp32 product (split TF32), or one
    bf16 product for bf16 operands. ``bound_fp32_ms`` is the same work at
    the fp32 CUDA-core rate."""
    ms, call = time_ms(fn)
    plain_ms, _ = time_ms(plain)
    lib = time_ms(library)[0] if library is not None else None
    pairs = n * m if pairs is None else pairs
    nbytes = 4.0 * b * (n + m) * d + 8.0 * b * n * kd + (4.0 * n * m if pos else 0)
    flops = 2.0 * b * pairs * d
    bms, by = (bound(flops, nbytes, PEAK_BF16_FLOPS) if bf16
               else bound(3.0 * flops, nbytes, PEAK_TF32_FLOPS))
    return dict(shape=[b, n, m, d, kd], ms=ms, call_ms=call, plain_ms=plain_ms,
                library_ms=lib, bound_ms=bms, bound_by=by,
                bound_fp32_ms=bound(flops, nbytes)[0])


def timings(per_request: dict) -> dict:
    phase("6. times at the main-path shapes (B = 8), CUDA events")
    rows: dict[str, list] = {"digc_topk": [], "mrconv": []}
    b = 8
    digc_shapes, mr = main_path_shapes("vig_ti_iso", "vig_ti_pyr")
    for n, m, d, kd in sorted(digc_shapes):
        x = to_dev(testing.features(1, b, n, d))
        y = to_dev(testing.features(2, b, m, d))
        rows["digc_topk"].append(digc_row(
            b, n, m, d, kd, lambda: digc_topk_cuda(x, y, kd),
            lambda: digc_topk_plain(x, y, kd),
            library=lambda: torch.topk(torch.cdist(x, y), kd, dim=-1,
                                       largest=False)))
        variants = {**PACKED_BF16, "pos_bias": dict(pos_bias=stage_pos_bias(n, m)),
                    **timed_legacy(m, kd)}
        xb, yb = x.bfloat16().float(), y.bfloat16().float()

        def exact():
            return torch.topk(torch.cdist(x, y), kd, dim=-1, largest=False)

        def rounded():
            return torch.topk(torch.cdist(xb, yb), kd, dim=-1, largest=False)

        library = {
            # packed keys: the same top-k up to ties; bf16: the distances
            # of the bf16-rounded operands (rounded before timing)
            "packed": exact, "legacy": exact, "legacy+packed": exact,
            "mxu_bf16": rounded, "packed+mxu_bf16": rounded,
            # squared distances, so the bias adds as the kernel adds it
            "pos_bias": lambda: torch.topk(
                torch.cdist(x, y).square_().add_(variants["pos_bias"]["pos_bias"]),
                kd, dim=-1, largest=False),
        }
        for vname, kw in variants.items():
            rows.setdefault(f"digc_topk.{vname}", []).append(digc_row(
                b, n, m, d, kd, lambda: digc_topk_cuda(x, y, kd, **kw),
                lambda: digc_topk_plain(x, y, kd, **kw),
                pos="pos_bias" in kw, bf16=kw.get("mxu_bf16", False),
                library=library.get(vname)))
    # The KNN attention shape: heads as the batch, causal and not.
    q, k, _ = (t.transpose(0, 1).contiguous() for t in knn_inputs())
    h, seq, dh, nn = KNN["heads"], KNN["seq"], KNN["dh"], KNN["nn"]
    above = torch.ones(seq, seq, dtype=torch.bool, device=DEV).triu(1)
    for vname, causal in (("digc_topk", False), ("digc_topk.causal", True)):
        rows.setdefault(vname, []).append(digc_row(
            h, seq, seq, dh, nn,
            lambda: digc_topk_cuda(q, k, nn, causal=causal),
            lambda: digc_topk_plain(q, k, nn, causal=causal),
            pairs=seq * (seq + 1) // 2 if causal else None,
            library=lambda: torch.topk(
                torch.cdist(q, k).masked_fill_(above, float("inf"))
                if causal else torch.cdist(q, k), nn, dim=-1, largest=False)))
    for n, m, d, k in sorted(mr):
        x = to_dev(testing.features(1, b, n, d))
        y = to_dev(testing.features(2, b, m, d))
        idx = to_dev(testing.neighbour_ids(3, b, n, k, m))
        flat_y = y.reshape(b * m, d)
        gid = (idx.long() + torch.arange(b, device=DEV)[:, None, None] * m).reshape(-1)
        ms, call = time_ms(lambda: mrconv_cuda(x, y, idx))
        plain, _ = time_ms(lambda: mrconv_plain(x, y, idx))
        lib, _ = time_ms(lambda: (flat_y.index_select(0, gid).reshape(b, n, k, d)
                                  - x[:, :, None]).amax(2))
        bms, by = bound(2.0 * b * n * k * d,
                        4.0 * b * (2 * n * d + m * d + n * k))
        rows["mrconv"].append(dict(shape=[b, n, m, d, k], ms=ms, call_ms=call,
                                   plain_ms=plain, library_ms=lib,
                                   bound_ms=bms, bound_by=by))
    labels = {"digc_topk": "torch.cdist + torch.topk (two calls)",
              "digc_topk.legacy": "torch.cdist + torch.topk (two calls)",
              "digc_topk.packed": "torch.cdist + torch.topk (two calls; the "
                                  "same top-k up to ties)",
              "digc_topk.legacy+packed": "torch.cdist + torch.topk (two "
                                         "calls; the same top-k up to ties)",
              "digc_topk.mxu_bf16": "torch.cdist on bf16-rounded operands + "
                                    "torch.topk (two calls)",
              "digc_topk.packed+mxu_bf16": "torch.cdist on bf16-rounded "
                                           "operands + torch.topk (two calls)",
              "digc_topk.bucket_rounds": "none (approximate: no PyTorch call "
                                         "computes it)",
              "digc_topk.pos_bias": "torch.cdist, square, + bias, torch.topk "
                                    "(four calls)",
              "digc_topk.causal": "torch.cdist, causal mask, torch.topk "
                                  "(three calls)",
              "mrconv": "index_select + subtract + amax (three calls)"}
    for name, rs in rows.items():
        if name in ("digc_topk", "mrconv"):
            print(f"{name}: launches per served request {per_request[name]:.2f}; "
                  f"library = {labels[name]}")
        else:  # launches: phases 8, 10 and 12
            print(f"{name}: library = "
                  f"{labels.get(name, 'none (no single PyTorch call)')}")
        rate = ("bf16 tensor cores" if name.endswith("mxu_bf16")
                else "split TF32 tensor cores" if name.startswith("digc")
                else "HBM")
        for r in rs:
            lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
            fp32 = ("" if "bound_fp32_ms" not in r else
                    f", fp32 CUDA-core bound {r['bound_fp32_ms']:.4f} ms")
            print(f"  {name} {r['shape']}: kernel {r['ms']:.4f} ms (per call "
                  f"from Python {r['call_ms']:.4f} ms), bound {r['bound_ms']:.4f} "
                  f"ms ({r['bound_by']}; {rate}){fp32}, plain "
                  f"{r['plain_ms']:.4f} ms, library {lib}")
    return rows


def variants_vs_plain() -> dict:
    phase("7. DIGC variants against their plain versions")
    digc_shapes, _ = main_path_shapes("vig_ti_iso", "vig_ti_pyr")
    errs: dict[str, float] = {}
    for b in (1, 8):
        for n, m, d, kd in sorted(digc_shapes):
            x = to_dev(testing.features(n + kd, b, n, d))
            y = to_dev(testing.features(m + d, b, m, d))
            variants = {**PACKED_BF16,
                        "pos_bias": dict(pos_bias=stage_pos_bias(n, m))}
            for vname, kw in variants.items():
                err, swaps = check_digc(x, y, kd, **kw)
                errs[vname] = max(errs.get(vname, 0.0), err)
                print(f"{vname:16s} B={b} N={n} M={m} D={d} kd={kd}: ok "
                      f"(max |dist err| {err:.3g}, near-tie swaps {swaps})")
    q, k, _ = (t.transpose(0, 1).contiguous() for t in knn_inputs())
    for vname, kw in (("causal", dict(causal=True)),
                      ("causal+packed", dict(causal=True, packed=True))):
        err, swaps = check_digc(q, k, KNN["nn"], **kw)
        errs[vname] = err
        print(f"{vname:16s} B={q.shape[0]} N=M={q.shape[1]} D={q.shape[2]} "
              f"kd={KNN['nn']}: ok (max |dist err| {err:.3g}, near-tie swaps "
              f"{swaps}; BIG lanes equal, indices in [0, M))")
    errs["mxu_bf16"] = max(errs["mxu_bf16"], errs.pop("packed+mxu_bf16"))
    errs["causal"] = max(errs["causal"], errs.pop("causal+packed"))
    return errs


def serving_variants() -> tuple[dict, dict]:
    variant = dict(packed=True, mxu_bf16=True)
    _, _, counts, _, capture, _, _ = serve_iso(
        "8. serving vig_ti_iso through the packed bf16 kernel",
        DigcSpec(impl="cuda", **variant), variant)
    # Algorithm 1 with a relative positional bias P through the public
    # digc(), on every layer's features.
    cfg = vig.VIG_VARIANTS["vig_ti_iso"]
    geo = [(dil, k) for p in vig.vig_stage_plans(cfg, "cuda")
           for dil, k in zip(p.dilations, p.k_effs)]
    grid = cfg.base_grid
    pos = grid_pos_bias(grid, grid, scale=POS_SCALE, device=DEV)
    reset_launch_counts()
    with torch.inference_mode():
        for (_, h, cond), (dil, k) in zip(capture, geo):
            digc(h, cond, k=k, dilation=dil, impl="cuda", pos_bias=pos)
    torch.cuda.synchronize()
    pos_counts = launch_counts()
    want = {"digc_topk": len(geo), "digc_topk.pos_bias": len(geo)}
    if fired(pos_counts) != want:
        raise AssertionError(f"launches {pos_counts}, expected {want}")
    worst = 0.0
    for (_, h, cond), (dil, k) in zip(capture, geo):
        y = h if cond is None else cond
        worst = max(worst, check_digc(h, y, k * dil, pos[None])[0])
    print(f"digc(impl='cuda', pos_bias=grid_pos_bias({grid}, {grid}, "
          f"scale={POS_SCALE})) on {len(geo)} layers' features: launches "
          f"{fired(pos_counts)}; equal to the plain version (max |dist err| "
          f"{worst:.3g})")
    return counts, pos_counts


def pyramid_blocked() -> None:
    phase("9. vig_ti_pyr forward at 224^2, B = 8, through the blocked tier")
    cfg = vig.VIG_VARIANTS["vig_ti_pyr"]
    params = convert.init_params(cfg, generator=torch.Generator().manual_seed(1),
                                 device=DEV)
    batch = to_dev(testing.images(100, 8, cfg.image_size))
    with torch.inference_mode():
        vig.vig_forward(params, batch, cfg)  # warm-up
        reset_launch_counts()
        t0 = time.perf_counter()
        out = vig.vig_forward(params, batch, cfg)  # the config's tier
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = launch_counts()
        ref = vig.vig_forward(params, batch, cfg, digc_impl="reference")
    if cfg.digc_impl != "blocked" or fired(counts):
        raise AssertionError(f"tier {cfg.digc_impl!r} launched {fired(counts)}")
    print(f"tier {cfg.digc_impl!r}: {ms:.2f} ms on the host clock, no kernel "
          f"launched (the streaming engine is plain PyTorch)")
    check_logits(out, ref)


def knn_attention_phase() -> dict:
    phase(f"10. knn_attention_mha, S = {KNN['seq']}, H = {KNN['heads']}, "
          f"Dh = {KNN['dh']}, {KNN['nn']} neighbours")
    q, k, v = knn_inputs()
    nn = KNN["nn"]
    reset_launch_counts()
    with torch.inference_mode():
        out = knn_attention_mha(q, k, v, num_neighbors=nn, impl="cuda")
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {"digc_topk": 1, "digc_topk.causal": 1}
    if fired(counts) != want:
        raise AssertionError(f"launches {counts}, expected {want}")
    with torch.inference_mode():
        ref = knn_attention_mha(q, k, v, num_neighbors=nn, impl="reference")
        qh, kh = (t.transpose(0, 1).contiguous() for t in (q, k))
        idx, dist = digc(qh, kh, k=nn, causal=True, impl="cuda",
                         return_dists=True)
        ref_i, ref_d = digc(qh, kh, k=nn, causal=True, impl="reference",
                            return_dists=True)
    big = dist >= BIG / 2
    if not (torch.isfinite(out).all() and ((idx >= 0) & (idx < kh.shape[1])).all()
            and (dist[big] == BIG).all() and torch.equal(big, ref_d >= BIG / 2)):
        raise AssertionError("KNN attention: non-finite output, an index "
                             "outside [0, S) or a BIG lane that is not 1e30")
    same = (idx == ref_i).all(-1).transpose(0, 1)  # (S, H)
    diff = (out - ref).abs().amax(-1)  # (S, H)
    if float(diff[same].max()) > 1e-5:
        raise AssertionError(f"rows with equal neighbour lists differ by "
                             f"{float(diff[same].max())}")
    print(f"launches {fired(counts)}; rows with the reference tier's neighbour "
          f"lists: {int(same.sum())} of {same.numel()}, max |out diff| there "
          f"{float(diff[same].max()):.3g}; over all rows {float(diff.max()):.3g}; "
          f"{int(big.sum())} BIG lanes, all exactly 1e30")
    return counts


def legacy_vs_plain() -> dict:
    phase("11. the legacy merge and bucket_rounds against their plain versions")
    digc_shapes, _ = main_path_shapes("vig_ti_iso", "vig_ti_pyr")
    errs = {"legacy": 0.0, "bucket_rounds": 0.0}
    for b in (1, 8):
        for n, m, d, kd in sorted(digc_shapes):
            x = to_dev(testing.features(n + kd, b, n, d))
            y = to_dev(testing.features(m + d, b, m, d))
            for vname, kw in legacy_cases(n, m, d, kd):
                err, swaps = check_digc(x, y, kd, **kw)
                key = "bucket_rounds" if vname.startswith("bucket") else "legacy"
                errs[key] = max(errs[key], err)
                print(f"{vname:16s} B={b} N={n} M={m} D={d} kd={kd} "
                      f"block_m={resolved_block_m(n, m, d, kd, kw)}: ok (max "
                      f"|dist err| {err:.3g}, near-tie swaps {swaps})")
    q, k, _ = (t.transpose(0, 1).contiguous() for t in knn_inputs())
    h, seq, dh, nn = KNN["heads"], KNN["seq"], KNN["dh"], KNN["nn"]
    pos = to_dev(testing.features(21, h, seq, seq))
    for vname, kw in (("mxu_bf16", dict(mxu_bf16=True)),
                      ("pos_bias", dict(pos_bias=pos)),
                      ("causal", dict(causal=True)),
                      ("causal+packed", dict(causal=True, packed=True))):
        kw = dict(kw, kernel_merge="legacy")
        err, swaps = check_digc(q, k, nn, **kw)
        errs["legacy"] = max(errs["legacy"], err)
        print(f"legacy+{vname:13s} B={h} N=M={seq} D={dh} kd={nn} "
              f"block_m={resolved_block_m(seq, seq, dh, nn, kw)}: ok (max "
              f"|dist err| {err:.3g}, "
              f"near-tie swaps {swaps}; BIG lanes equal)")
    return errs


def print_tuning(log: list) -> None:
    """Each measured tuning: the ranked candidates with their priors, the
    measured call times (oracle first; device times of those within 10%
    of the fastest) and the choice."""
    for entry in log:
        print(f"  workload {entry['key']}: ranked (prior us) "
              + ", ".join(f"{describe(c)} {p * 1e6:.1f}"
                          for c, p in entry["ranked"][:8]) + ", ...")
        for r in entry["measured"]:
            dev = "" if r.device_us is None else f", device {r.device_us:.1f} us"
            print(f"    measured {describe(r.config):34s} {r.us_per_call:9.1f} us"
                  f"{dev}{'' if r.exact_match else ' (indices differ: ineligible)'}")
        print(f"    chosen {describe(entry['chosen'].config)}")


def describe(c) -> str:
    if c.impl == "cuda":
        return f"cuda {c.kernel_merge} {c.block_n}x{c.block_m}"
    return (f"blocked {c.merge}{'+fuse' if c.fuse_norms else ''} "
            f"{c.block_n}x{c.block_m}")


def expected_launches(eng, ticks: list) -> dict:
    """Kernel launches a pass over ``ticks`` makes through the engine's
    bucket schedules (12 DIGC blocks per tick, all in stage 0)."""
    want: dict = {}
    for bucket in ticks:
        spec = eng._bucket_choice(bucket).spec_for(0)
        if spec.impl == "cuda":
            for name in ("digc_topk", "mrconv") + (
                    ("digc_topk.legacy",) if spec.kernel_merge == "legacy" else ()):
                want[name] = want.get(name, 0) + 12
    return want


def tuned_serving(rps_exact: float) -> tuple[dict, dict, dict]:
    phase("12. serving vig_ti_iso at full width through the tuned path")
    cfg = vig.VIG_VARIANTS["vig_ti_iso"]
    params = convert.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                 device=DEV)
    images = [testing.images(uid, 1, cfg.image_size)[0] for uid in range(20)]
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "tune.json"
        reset_launch_counts()
        t0 = time.perf_counter()
        eng = VigServeEngine(cfg, params, autotune=True, tuner_path=path,
                             device=DEV)
        if eng.spec.impl != "blocked":
            raise AssertionError(f"config tier {eng.spec.impl!r}")
        eng.warmup()
        serve_trace(eng, images)  # each bucket's first tick tunes them all
        torch.cuda.synchronize()
        tune_s = time.perf_counter() - t0
        tuning = launch_counts()
        print(f"tuning and the first pass: {tune_s:.2f} s, launches "
              f"{fired(tuning)}")
        print_tuning(eng.tune_log)
        if not tuning["digc_topk.legacy"]:
            raise AssertionError("the legacy merge never launched while tuning")
        stats = eng.stats()
        for b, sched in sorted(stats["bucket_schedules"].items()):
            print(f"bucket {b}: schedule {json.dumps(sched)}")
        ticks = [eng.bucket_for(len(t)) for t in trace_ticks()]
        reset_launch_counts()
        reqs, lat, seconds = serve_trace(eng, images)
        counts = launch_counts()
        rps = len(reqs) / seconds
        if fired(counts) != expected_launches(eng, ticks):
            raise AssertionError(f"launches {counts}, expected "
                                 f"{expected_launches(eng, ticks)}")
        logits = np.stack([r.logits for r in reqs])
        if logits.shape != (20, 1000) or not np.isfinite(logits).all():
            raise AssertionError("tuned serving: logits not finite")
        print(f"tuned path: {rps:.2f} requests/s ({seconds * 1e3:.1f} ms), "
              f"phase 4 (cuda spec) in this run: {rps_exact:.2f}; launches "
              f"{fired(counts)}")
        for b in sorted(lat):
            print(f"bucket {b}: median tick {statistics.median(lat[b]):.2f} ms "
                  f"over {len(lat[b])} ticks")
        # The same trace through the phase-4 spec and the tuned path in
        # turns (spec, tuned, tuned, spec): the host's speed drifts
        # between phases.
        spec_eng = VigServeEngine(cfg, params, digc_impl="cuda", device=DEV)
        serve_trace(spec_eng, images)
        turns = [("cuda spec", spec_eng), ("tuned", eng), ("tuned", eng),
                 ("cuda spec", spec_eng)]
        print("in turns, requests/s: " + ", ".join(
            f"{name} {20 / serve_trace(e, images)[2]:.2f}"
            for name, e in turns))
        # A second engine on the same cache: every schedule cached, and the
        # only launches are those of the served schedules.
        reset_launch_counts()
        eng2 = VigServeEngine(cfg, params, tuner_path=path, device=DEV)
        eng2.warmup()
        serve_trace(eng2, images)
        torch.cuda.synchronize()
        second = launch_counts()
        sources = {r.source for r in eng2.tuned} | {
            r.source for rs in eng2._bucket_tuned.values() for r in rs}
        if sources != {"cached"} or eng2.tune_log:
            raise AssertionError(f"second engine tuned: {sources}")
        if fired(second) != expected_launches(eng2, ticks):
            raise AssertionError(f"second engine launches {second}")
        print(f"second engine on the cache: nothing tuned, launches "
              f"{fired(second)}")
        for name, e in (("tuned", eng), ("cuda spec", spec_eng),
                        ("second tuned", eng2)):
            assert_no_faults(e, f"phase 12, {name} engine")
        new = eng2.retune_buckets()
        auto = VigServeEngine(cfg, params, tuner_path=path, buckets="auto",
                              device=DEV)
        print(f"lane_hist {eng2.stats()['lane_hist']}: retune_buckets() -> "
              f"{new}; buckets='auto' reads {auto.buckets}")
        if auto.buckets != new:
            raise AssertionError("buckets='auto' did not read the retuned set")
    # The trace through the bucket_rounds spec phase 11 checked.
    spec = DigcSpec(impl="cuda", **BUCKET_SPEC)
    beng = VigServeEngine(cfg, params, digc_impl=spec, device=DEV)
    serve_trace(beng, images)
    reset_launch_counts()
    breqs, _, bsec = serve_trace(beng, images)
    bucket_counts = launch_counts()
    want = 12 * len(trace_ticks())
    expect = {"digc_topk": want, "mrconv": want, "digc_topk.packed": want,
              "digc_topk.legacy": want, "digc_topk.bucket_rounds": want}
    if fired(bucket_counts) != expect:
        raise AssertionError(f"launches {bucket_counts}, expected {expect}")
    assert_no_faults(beng, "phase 12, bucket_rounds engine")
    blogits = np.stack([r.logits for r in breqs])
    if not np.isfinite(blogits).all():
        raise AssertionError("bucket_rounds serving: logits not finite")
    print(f"bucket_rounds {BUCKET_SPEC}: {len(breqs) / bsec:.2f} requests/s, "
          f"launches {fired(bucket_counts)}; logits vs the tuned path's max "
          f"|diff| {float(np.abs(blogits - logits).max()):.3g}")
    fit_cost_constants(eng.tune_log)
    return tuning, bucket_counts, counts


def fit_cost_constants(tune_log: list) -> dict:
    """The cost model's fitted ``"cuda"`` terms. The blocked tier's
    per-tile term (``_ENGINE_CONSTANTS["cuda"]["tile"]``): the least-squares
    fit, through the origin, of 16 calls' times (B = 8, four main-path
    shapes, four tilings; each the tuner's CUDA-event time) against their
    tile counts. The kernel's per-call term (``_CUDA_KERNEL_CALL_S``): the
    median over the tuning's measured ``cuda`` candidates of measured time
    minus the Hopper estimate."""
    tiles, times = [], []
    for n, m, d, kd in ((196, 196, 192, 18), (3136, 196, 48, 9),
                        (784, 196, 96, 9), (49, 49, 384, 27)):
        x = to_dev(testing.features(n, 8, n, d))
        y = to_dev(testing.features(m, 8, m, d))
        for bn, bm, merge, fuse in ((None, m, "select", False),
                                    (None, 64, "select", False),
                                    (256, 128, "select", True),
                                    (64, 64, "topk", False)):
            spec = DigcSpec(impl="blocked", k=kd, block_n=bn, block_m=bm,
                            merge=merge, fuse_norms=fuse or None)
            with torch.inference_mode():
                digc(x, y, spec=spec)
                t = time_calls(lambda: digc(x, y, spec=spec), DEV, 5)
            count = perfmodel.engine_cost_estimate(
                n, m, d, kd, b=8, block_n=bn, block_m=bm, merge=merge,
                fuse_norms=fuse, constants=dict(
                    gemm=0.0, topk=0.0, lane=0.0, byte=0.0, tile=1.0,
                    cache=50e6))["total_s"]
            tiles.append(count)
            times.append(t)
            print(f"  blocked {(n, m, d, kd, bn, bm, merge, fuse)}: "
                  f"{t * 1e6:.1f} us over {count:.0f} tiles")
    tiles, times = np.array(tiles), np.array(times)
    tile = float(tiles @ times / (tiles @ tiles))
    print(f"engine constant 'tile' for 'cuda' (least squares over "
          f"{len(times)} blocked-tier calls): {tile!r} s; fitted vs measured "
          f"us: " + ", ".join(f"{p * 1e6:.0f}/{t * 1e6:.0f}"
                             for p, t in zip(tiles * tile, times)))
    residuals = []
    for entry in tune_log:
        b, n, m, d, kd = entry["shape"]
        for r in entry["measured"]:
            if r.config.impl == "cuda":
                dev = perfmodel.kernel_cost_estimate(
                    n, m, d, kd, b=b, block_n=r.config.block_n,
                    block_m=r.config.block_m,
                    kernel_merge=r.config.kernel_merge,
                    mxu_bf16=entry["mxu_bf16"], backend="cuda",
                    call_s=0.0)["total_s"]
                residuals.append(r.us_per_call * 1e-6 - dev)
    call = float(statistics.median(residuals))
    print(f"kernel per-call term for 'cuda' (median of {len(residuals)} "
          f"measured candidates minus the Hopper estimate): {call!r} s; "
          f"residuals us: " + ", ".join(f"{v * 1e6:.1f}" for v in residuals))
    return {"tile": tile, "kernel_call": call}


def pyramid_tuned() -> dict:
    phase("13. tune_schedule for vig_ti_pyr at 224^2, B = 8, and its forward")
    cfg = vig.VIG_VARIANTS["vig_ti_pyr"]
    params = convert.init_params(cfg, generator=torch.Generator().manual_seed(1),
                                 device=DEV)
    batch = to_dev(testing.images(100, 8, cfg.image_size))
    rows: dict = {}
    for row in vig.count_digc_work(cfg):
        rows.setdefault(row["stage"], row)
    with tempfile.TemporaryDirectory() as tmp:
        tuner = DigcTuner(Path(tmp) / "pyr.json", device=DEV)
        reset_launch_counts()
        t0 = time.perf_counter()
        sched, results = tuner.tune_schedule(
            [rows[s] for s in sorted(rows)],
            spec=DigcSpec(impl="blocked", k=cfg.k), batch=8)
        torch.cuda.synchronize()
        tune_s = time.perf_counter() - t0
    tuning = launch_counts()
    print(f"tuned 4 stages in {tune_s:.2f} s; launches while tuning "
          f"{fired(tuning)}")
    print_tuning(tuner.log)
    for st in sched.describe():
        print(f"  stage {st['stage']}: {json.dumps(st)}")
    reset_launch_counts()
    with torch.inference_mode():
        out = vig.vig_forward(params, batch, cfg, digc_impl=sched)
        torch.cuda.synchronize()
        counts = launch_counts()
        ref = vig.vig_forward(params, batch, cfg, digc_impl="reference")
    plans = vig.vig_stage_plans(cfg, sched)
    want: dict = {}
    for p in plans:
        if p.spec.impl == "cuda":
            for name in ("digc_topk", "mrconv") + (
                    ("digc_topk.legacy",) if p.spec.kernel_merge == "legacy" else ()):
                want[name] = want.get(name, 0) + p.depth
    if fired(counts) != want:
        raise AssertionError(f"forward launches {counts}, expected {want}")
    print(f"forward through the schedule: launches {fired(counts)}")
    check_logits(out, ref)
    return tuning


def bucket_batch(eng, reqs: list) -> tuple[list, int]:
    """The last tick's requests in slot order (a one-shot's slot is the
    lane no tenant holds) and its bucket."""
    slot = {id(r): eng._tenant_slot[r.tenant] for r in reqs
            if r.tenant is not None}
    free = [s for s in eng.last_lanes if s not in slot.values()]
    for r in reqs:
        if r.tenant is None:
            slot[id(r)] = free.pop(0)
    return sorted(reqs, key=lambda r: slot[id(r)]), eng.last_bucket


def stack_batch(order: list, bucket: int) -> np.ndarray:
    """The bucket batch as the engine builds it: the images in slot order,
    padded by replicating lane 0."""
    imgs = [np.asarray(r.image, np.float32) for r in order]
    return np.stack(imgs + [imgs[0]] * (bucket - len(imgs)))


def stateful_serving(phase4_counts: dict, rps_phase4: float) -> None:
    phase("14. stateful serving of vig_ti_iso on the cuda tier")
    cfg = vig.VIG_VARIANTS["vig_ti_iso"]
    params = convert.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                 device=DEV)
    images = [testing.images(uid, 1, cfg.image_size)[0] for uid in range(20)]
    eng = VigServeEngine(cfg, params, digc_impl="cuda", device=DEV)
    serve_trace(eng, images)  # warm-up pass
    reset_launch_counts()
    batches: list = []
    uid_reqs, _, _ = serve_trace(eng, images, batches)
    torch.cuda.synchronize()
    counts = launch_counts()
    if fired(counts) != fired(phase4_counts):
        raise AssertionError(f"launches {fired(counts)}, phase 4 "
                             f"{fired(phase4_counts)}")
    check_bucket_forwards(params, cfg, "cuda", batches)
    assert_no_faults(eng, "phase 14")
    steps = eng.slot_row_steps()
    if any(any(v) for v in steps.values()) or eng.stats()["gate_reads"]:
        raise AssertionError(f"the stateless tier moved the state: {steps}")
    print(f"{len(uid_reqs)} requests over {len(batches)} ticks: logits bit "
          f"for bit those of a stateless forward of each bucket batch; "
          f"launches {fired(counts)} (phase 4: {fired(phase4_counts)}); "
          f"state rows unchanged; parked {eng.stats()['parked_tenants']}")

    def stateless_pass() -> float:
        """The same bucket batches through vig_forward with no engine and
        no state: per tick, stack the images as the engine does, upload,
        forward, logits to the host."""
        t0 = time.perf_counter()
        with torch.inference_mode():
            for order, bucket in batches:
                batch = torch.from_numpy(stack_batch(order, bucket)).to(DEV)
                out = vig.vig_forward(params, batch, cfg, digc_impl="cuda")
                out[:len(order)].cpu().numpy()
        return time.perf_counter() - t0

    stateless_pass()
    rps: dict = {"engine": [], "stateless": []}
    for _ in range(3):
        for name in ("engine", "stateless", "stateless", "engine"):
            sec = (serve_trace(eng, images)[2] if name == "engine"
                   else stateless_pass())
            rps[name].append(20 / sec)
    print(f"requests/s: phase 4 (the stateful engine, earlier in this call) "
          f"{rps_phase4:.2f}; in turns (engine, stateless, stateless, engine, "
          f"three rounds), the stateful engine: "
          f"{', '.join(f'{v:.2f}' for v in rps['engine'])} (median "
          f"{statistics.median(rps['engine']):.2f}); a stateless forward of "
          f"the same bucket batches: "
          f"{', '.join(f'{v:.2f}' for v in rps['stateless'])} (median "
          f"{statistics.median(rps['stateless']):.2f})")
    # The per-tick row copies alone, at bucket 8 with 5 live lanes.
    state = eng._ensure_slot_state()
    rows, lanes = [0, 1, 2, 3, 4, 0, 0, 0], [0, 1, 2, 3, 4]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        state.put_rows(state.take_rows(rows), lanes)
    torch.cuda.synchronize()
    print(f"take_rows + put_rows of a bucket-8 tick: "
          f"{(time.perf_counter() - t0) * 10:.3f} ms on the host clock "
          f"(mean of 100, synchronized after the loop)")


# Phase 15's trace: pixel noise between a video tenant's frames (pixels
# are N(0, 1): a static scene with sensor noise), frames a tenant, video
# tenants, and the drift gates tune_reuse sweeps.
VIDEO_SIGMA = 0.001
VIDEO_FRAMES = 8
VIDEO_TENANTS = 8
TAUS = (1e-5, 1e-4, 1e-3, 1e-2)


def video_frames(size: int) -> dict:
    """{tenant: frames}: VIDEO_TENANTS video-like tenants (frame t + 1 =
    frame t + N(0, VIDEO_SIGMA^2) pixel noise) and "new", whose every
    frame is a new image."""
    rng = np.random.default_rng(15)
    frames = {}
    for i in range(VIDEO_TENANTS):
        seq = [testing.images(1000 + i, 1, size)[0]]
        for _ in range(VIDEO_FRAMES - 1):
            seq.append((seq[-1] + VIDEO_SIGMA * rng.standard_normal(
                seq[-1].shape)).astype(np.float32))
        frames[f"v{i}"] = seq
    frames["new"] = [testing.images(2000 + t, 1, size)[0]
                     for t in range(VIDEO_FRAMES)]
    return frames


def serve_video(eng, frames: dict, log=None) -> dict:
    """Every tenant's frame t at tick t. Returns each tick's requests and
    host-clock ms, and whether the new-image tenant's graph snapshot
    moved (it rebuilt) on every tick. With ``log`` (a recording digc),
    the served-vs-fresh neighbour hits of the live rows."""
    out = {"reqs": [], "ms": [], "rebuilt": [], "reads": [], "hits": 0,
           "total": 0}
    for t in range(VIDEO_FRAMES):
        reqs = [VigRequest(100 * t + i, seq[t], tenant=name)
                for i, (name, seq) in enumerate(frames.items())]
        for r in reqs:
            eng.submit(r)
        def new_snap():
            """The new-image tenant's graph snapshot, None before it has a
            slot or without stale-graph buffers (reuse off)."""
            st = eng._slot_state
            if st is None or "new" not in eng._tenant_slot:
                return None
            snaps = st.entries["stage0"].graph_snap
            return None if snaps is None else snaps[eng._tenant_slot["new"]].item()

        before = new_snap()
        if log is not None:
            log.clear()
        reads = eng.gate_reads
        s = time.perf_counter()
        eng.step()
        out["ms"].append((time.perf_counter() - s) * 1e3)
        out["reads"].append(eng.gate_reads - reads)
        out["reqs"].append(reqs)
        out["rebuilt"].append(before is None or new_snap() != before)
        a = len(eng.last_lanes)
        for served, fresh in (log or []):
            out["hits"] += int((served[:a, :, :, None] == fresh[:a, :, None, :])
                               .any(-1).sum())
            out["total"] += fresh[:a].numel()
    return out


def recording_digc(log: list):
    """A stand-in for ``models.vig``'s digc that also records each call's
    served graph beside a fresh build on the same features."""
    real = vig.digc

    def record(h, cond=None, *, spec, **kw):
        out = real(h, cond, spec=spec, **kw)
        fresh = real(h, cond, spec=spec.replace(reuse=None, drift_tau=None,
                                                max_stale=None))
        log.append((out[0] if isinstance(out, tuple) else out, fresh))
        return out

    return real, record


def stale_graph_serving() -> DigcSpec:
    phase(f"15. stale-graph serving of vig_ti_iso on the blocked tier: "
          f"{VIDEO_TENANTS} video tenants x {VIDEO_FRAMES} frames "
          f"(sigma {VIDEO_SIGMA}) + a new-image tenant")
    cfg = vig.VIG_VARIANTS["vig_ti_iso"]
    params = convert.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                 device=DEV)
    frames = video_frames(cfg.image_size)
    off = DigcSpec(impl="blocked", k=cfg.k)

    def engine(spec, cls=VigServeEngine):
        return cls(cfg, params, digc_impl=spec, autotune=False,
                   buckets=(1, 2, 4, 8, 16), device=DEV)

    reset_launch_counts()
    base = serve_video(engine(off), frames)
    zero_spec = off.replace(reuse="tick", drift_tau=0.0)
    zero_eng = engine(zero_spec)
    zero = serve_video(zero_eng, frames)
    for reqs, zreqs in zip(base["reqs"], zero["reqs"]):
        for r, z in zip(reqs, zreqs):
            if not np.array_equal(r.logits, z.logits):
                raise AssertionError(f"drift_tau=0 request {z.uid}: logits "
                                     "differ from reuse=None")
    assert_no_faults(zero_eng, "phase 15, drift_tau=0")
    if zero_eng.stats()["gate_reads"] or zero_eng.stats()["graph_reuses"]:
        raise AssertionError("drift_tau=0 engaged the gate")
    print(f"reuse='tick', drift_tau=0.0: {sum(map(len, zero['reqs']))} "
          f"requests bit for bit those of reuse=None; no gate read")

    # tune_reuse on the features of the first 3 ticks (tenants in slot
    # order, as the engine batches them)
    ticks = []
    with torch.inference_mode():
        for t in range(3):
            cap: list = []
            batch = np.stack([seq[t] for seq in frames.values()])
            vig.vig_forward(params, to_dev(batch), cfg, digc_impl=off,
                            digc_capture=cap)
            ticks.append(cap)
        stats = [drift_stat(h).cpu().numpy() for t in ticks for _, h, _ in t[:1]]
    print("block-0 drift between ticks 0-1, 1-2, per tenant: " + "; ".join(
        " ".join(f"{v:.2e}" for v in np.abs(b - a) / np.abs(a))
        for a, b in zip(stats, stats[1:])))
    tuned, results = tune_reuse(ticks, spec=off, policy="tick", taus=TAUS)
    for r in results:
        print(f"  tune_reuse tick tau {r.drift_tau:g}: reuse {r.reuse_frac:.3f}, "
              f"recall {r.recall:.4f}, admitted {r.admitted}")
    if tuned.reuse is not None:
        tau = tuned.drift_tau
        print(f"admitted tau {tau:g}")
    else:
        tau = TAUS[0]
        print(f"no tau admitted at the 0.95 recall floor; the policies below "
              f"serve at the smallest swept tau, {tau:g}, for the measurement")

    policies = ("tick", "layer", "overlap")
    specs = {p: off.replace(reuse=p, drift_tau=tau, max_stale=4)
             for p in policies}
    # Latency passes in turns (off, the policies, then back), each on a
    # fresh engine; the medians pool both passes' ticks.
    ms: dict = {"off": [], **{p: [] for p in policies}}
    runs: dict = {}
    order = ("off",) + policies
    for name in order + order[::-1]:
        eng = engine(off if name == "off" else specs[name])
        res = serve_video(eng, frames)
        ms[name] += res["ms"]
        runs[name] = (eng, res)
    counts = launch_counts()
    if fired(counts):
        raise AssertionError(f"the blocked tier launched {fired(counts)}")
    print(f"reuse=None: median tick {statistics.median(ms['off']):.2f} ms "
          f"over {len(ms['off'])} ticks (9 live lanes, bucket 16)")
    for name, (eng, _) in runs.items():
        assert_no_faults(eng, f"phase 15, {name}")
    for p in policies:
        eng, res = runs[p]
        st = eng.stats()
        lanes = st["graph_reuses"] + st["graph_rebuilds"]
        log: list = []
        real, record = recording_digc(log)
        vig.digc = record
        try:  # eagerly: a replayed graph calls no Python to record
            rec = serve_video(engine(specs[p], EagerEngine), frames, log)
        finally:
            vig.digc = real
        if not all(res["rebuilt"]) or not all(rec["rebuilt"]):
            raise AssertionError(f"{p}: the new-image tenant served a cached "
                                 f"graph on a tick: {res['rebuilt']}")
        for reqs in res["reqs"]:
            if not all(np.isfinite(r.logits).all() for r in reqs):
                raise AssertionError(f"{p}: non-finite logits")
        print(f"{p} (tau {tau:g}, max_stale 4): reuse fraction "
              f"{st['graph_reuses'] / lanes:.3f} (graph_reuses "
              f"{st['graph_reuses']} / graph_rebuilds {st['graph_rebuilds']}); "
              f"served-vs-fresh recall {rec['hits'] / rec['total']:.4f}; host "
              f"reads per tick {st['gate_reads'] / VIDEO_FRAMES:.1f}; median "
              f"tick {statistics.median(ms[p]):.2f} ms (reuse=None "
              f"{statistics.median(ms['off']):.2f}); drift mean "
              f"{st['drift']['mean']:.3g}; new-image tenant rebuilt every tick")
    return specs


def parking(spec: DigcSpec) -> None:
    phase("16. parking: 6 tenants cycling through 4 slots, park_capacity 8")
    cfg = vig.VIG_VARIANTS["vig_ti_iso"]
    params = convert.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                 device=DEV)
    frames = video_frames(cfg.image_size)
    names = [f"v{i}" for i in range(6)]
    eng = VigServeEngine(cfg, params, digc_impl=spec, autotune=False,
                         buckets=(1, 2, 4), park_capacity=8, device=DEV)
    served = {n: 0 for n in names}
    warm_returns = 0
    reset_launch_counts()
    for t in range(VIDEO_FRAMES):
        tick = [names[(t + j) % 6] for j in range(4)]
        for n in tick:  # a still scene: each tenant resends its first frame
            eng.submit(VigRequest(100 * t + served[n], frames[n][0], tenant=n))
            served[n] += 1
        eng.step()
        ent = eng._slot_state.entries["stage0"]
        for slot in eng.last_restores:
            age = int(ent.graph_age[slot])
            if age <= 0:
                raise AssertionError(f"tick {t}: re-admitted {eng.slot_tenant[slot]} "
                                     f"rebuilt (graph_age {age})")
            warm_returns += 1
    if fired(launch_counts()):
        raise AssertionError(f"the blocked tier launched {fired(launch_counts())}")
    assert_no_faults(eng, "phase 16")
    st = eng.stats()
    if st["park_hits"] <= 0 or warm_returns != st["park_hits"]:
        raise AssertionError(f"park_hits {st['park_hits']}, warm returns "
                             f"{warm_returns}")
    parked = st["parked_tenants"]
    print(f"park_hits {st['park_hits']} (each returning tenant served its "
          f"cached graph, graph_age > 0), park_evictions "
          f"{st['park_evictions']}, parked {parked}, graph_reuses "
          f"{st['graph_reuses']} / graph_rebuilds {st['graph_rebuilds']}")
    gone = parked[0]
    eng.release(gone)
    bound = next(n for n in names if n in eng._tenant_slot)
    slot = eng._tenant_slot[bound]
    eng.release(bound)
    ent = eng._slot_state.entries["stage0"]
    if (gone in eng._parked or eng.slot_tenant[slot] is not None
            or int(ent.row_step[slot]) or int(ent.graph_age[slot])):
        raise AssertionError("release() kept a parked copy or a slot's rows")
    print(f"release({gone!r}) dropped its parked copy; release({bound!r}) "
          f"freed slot {slot} and reset its rows")


FAULT_COUNTERS = ("quarantines", "state_resets", "deadline_misses",
                  "park_losses", "retries", "requests_failed",
                  "fallback_level")


def fault_counters(eng) -> dict:
    st = eng.stats()
    out = {k: st[k] for k in FAULT_COUNTERS}
    out["faults"] = [f["kind"] for f in st["faults"]]
    return out


def faults_on_card(reuse_spec: DigcSpec) -> None:
    phase("17. faults on the card: vig_ti_iso at full width, bucket 4")
    cfg = vig.VIG_VARIANTS["vig_ti_iso"]
    params = convert.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                 device=DEV)
    frames = video_frames(cfg.image_size)
    names = ["v0", "v1", "v2"]  # bound to slots 0, 1, 2

    def engine(plan=None, spec="cuda", buckets=(4,), **kw):
        return VigServeEngine(cfg, params, digc_impl=spec, autotune=False,
                              buckets=buckets, fault_plan=plan, device=DEV,
                              **kw)

    def run(eng, ticks=4) -> dict:
        """Frame t of v0-v2 at tick t + 1; the requests by (t, tenant)."""
        reqs = {}
        for t in range(ticks):
            for i, n in enumerate(names):
                reqs[(t, n)] = r = VigRequest(100 * t + i, frames[n][t],
                                              tenant=n)
                eng.submit(r)
            eng.step()
        return reqs

    def same(reqs, ref, skip=()) -> None:
        for key, r in reqs.items():
            if key not in skip and not np.array_equal(r.logits, ref[key].logits):
                raise AssertionError(f"{key}: logits differ from the "
                                     "fault-free replay")

    clean_eng = engine()
    clean = run(clean_eng)
    assert_no_faults(clean_eng, "phase 17 fault-free replay")
    # A non-finite image: its lane is quarantined, the others are served
    # bit for bit (the kernel tier is stateless, so every later tick too).
    plan = FaultPlan(seed=1).inject_nonfinite_input("v1", tick=2)
    eng = engine(plan)
    reqs = run(eng)
    bad = reqs[(1, "v1")]
    if bad.fault is None or bad.fault.kind != "nonfinite_input" or bad.logits is not None:
        raise AssertionError(f"non-finite image not quarantined: {bad.fault}")
    same(reqs, clean, skip={(1, "v1")})
    print(f"cuda, non-finite image of v1 at tick 2: quarantined; the other "
          f"{len(reqs) - 1} requests bit for bit the fault-free replay; "
          f"{fault_counters(eng)}")
    # A row_step bitflip (the kernel tier's only state field): the tokens
    # catch it and the lane is served cold.
    plan = FaultPlan(seed=2).inject_state_corruption(
        field="row_step", row=1, tick=2, mode="bitflip")
    eng = engine(plan)
    reqs = run(eng)
    got = fault_counters(eng)
    if (plan.counts() != {"state_corruption": 1} or got["state_resets"] != 1
            or got["quarantines"] or got["faults"] != ["state_corruption"]):
        raise AssertionError(f"row_step bitflip: {plan.fired}, {got}")
    same(reqs, clean)
    print(f"cuda, {plan.fired[0].detail}: detected and served cold, every "
          f"request bit for bit the fault-free replay; {got}")
    # Every cuda build fails: the ladder serves on the blocked tier.
    plan = FaultPlan(seed=3).inject_build_failure(impl="cuda", times=None)
    eng = engine(plan)
    reqs = run(eng)
    st = eng.stats()
    if st["fallback_level"] != 1 or st.get("fallback_impl") != "blocked":
        raise AssertionError(f"build failure: {fault_counters(eng)}")
    blocked = degraded_spec(eng.spec, "blocked")
    gap = 0.0
    with torch.inference_mode():
        for t in range(4):
            batch = np.stack([frames[n][t] for n in names] + [frames["v0"][t]])
            want = vig.vig_forward(params, to_dev(batch), cfg,
                                   digc_impl=blocked).cpu().numpy()
            scale = max(1.0, float(np.abs(want).max()))
            for i, n in enumerate(names):
                got = reqs[(t, n)].logits
                if not np.allclose(got, want[i], rtol=0, atol=1e-5 * scale):
                    raise AssertionError(f"{(t, n)}: degraded logits differ "
                                         "from a blocked forward")
                gap = max(gap, float(np.abs(got - clean[(t, n)].logits).max()))
    print(f"cuda, persistent build failure: fallback_level 1 "
          f"({st['fallback_impl']}); logits equal a blocked forward of each "
          f"bucket batch (atol 1e-5 x the largest logit); max |diff| to the "
          f"cuda tier {gap:.3g}; {fault_counters(eng)}")
    # Slow ticks over the budget degrade after deadline_strikes misses.
    plan = FaultPlan(seed=4).inject_slow_tick(seconds=0.2, times=3)
    eng = engine(plan, deadline_ms=100.0, deadline_strikes=2)
    run(eng, ticks=3)
    got = fault_counters(eng)
    if (got["deadline_misses"], got["fallback_level"], got["faults"]) != (
            2, 1, ["deadline_miss", "deadline_miss", "deadline_degrade"]):
        raise AssertionError(f"deadline: {got}")
    print(f"cuda, 3 ticks slowed 0.2 s over a 100 ms budget: the first (the "
          f"capture's tick) skipped, 2 misses, degraded; {got}")
    # The blocked tier with reuse: a NaN in the cached graph's snapshot
    # quarantines its lane; co-batched lanes are bit for bit fault-free.
    clean_reuse = run(engine(spec=reuse_spec))
    plan = FaultPlan(seed=5).inject_state_corruption(
        field="graph_snap", row=1, tick=2, mode="nan")
    eng = engine(plan, spec=reuse_spec)
    reqs = run(eng)
    bad = reqs[(1, "v1")]
    if bad.fault is None or bad.fault.kind != "nonfinite_state":
        raise AssertionError(f"graph_snap NaN not quarantined: {bad.fault}")
    same(reqs, clean_reuse, skip={(t, "v1") for t in range(1, 4)})
    print(f"blocked tick reuse, {plan.fired[0].detail}: quarantined; v0 and "
          f"v2 bit for bit the fault-free replay; {fault_counters(eng)}")
    # A parking loss: v0 is evicted (parked), its copy is lost, and it
    # returns cold (one tick's 12 gated calls on its row counter).
    plan = FaultPlan(seed=6).inject_parking_loss("v0")
    eng = engine(plan, spec=reuse_spec, buckets=(2,))
    for t, tick in enumerate((["v0", "v1"], ["v2"], ["v0"])):
        for i, n in enumerate(tick):
            eng.submit(VigRequest(10 * t + i, frames[n][t], tenant=n))
        eng.step()
    slot = eng._tenant_slot["v0"]
    steps = eng.slot_row_steps()["stage0"][slot]
    got = fault_counters(eng)
    if (got["park_losses"] != 1 or slot not in eng.last_resets or steps != 12
            or eng.stats()["park_hits"]):
        raise AssertionError(f"parking loss: {got}, row_step {steps}")
    print(f"blocked tick reuse, parking loss of v0: re-admitted cold "
          f"(row_step {steps}); {got}")
    # What the guards cost: bucket-8 ticks of eight tenants, guarded and
    # unguarded engines in turns, after each engine's first (capturing)
    # tick.
    tenants = [f"v{i}" for i in range(8)]
    engines = {"guarded": engine(buckets=(8,)),
               "unguarded": engine(buckets=(8,), guards=False)}
    ms: dict = {k: [] for k in engines}

    def tick(name, t):
        eng = engines[name]
        for i, n in enumerate(tenants):
            eng.submit(VigRequest(100 * t + i, frames[n][t % VIDEO_FRAMES],
                                  tenant=n))
        s = time.perf_counter()
        eng.step()
        return (time.perf_counter() - s) * 1e3

    for name in engines:
        tick(name, 0)
    for r in range(4):
        for name in ("guarded", "unguarded", "unguarded", "guarded"):
            ms[name] += [tick(name, 1 + 4 * r + j) for j in range(4)]
    for name, eng in engines.items():
        assert_no_faults(eng, f"phase 17, {name} timing engine")
    g, u = statistics.median(ms["guarded"]), statistics.median(ms["unguarded"])
    print(f"bucket-8 tick, median over {len(ms['guarded'])} ticks each, in "
          f"turns: guarded {g:.3f} ms, unguarded {u:.3f} ms (guards "
          f"{g - u:+.3f} ms, {100 * (g / u - 1):+.1f}%)")


def captured_vs_eager(specs: dict) -> None:
    phase("18. captured bucket programs against the eager engine")
    cfg = vig.VIG_VARIANTS["vig_ti_iso"]
    params = convert.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                 device=DEV)
    images = [testing.images(uid, 1, cfg.image_size)[0] for uid in range(20)]
    engines = {"captured": VigServeEngine(cfg, params, digc_impl="cuda",
                                          device=DEV),
               "eager": EagerEngine(cfg, params, digc_impl="cuda", device=DEV)}
    counts, lat, rps, logits = {}, {}, {}, {}
    for name, eng in engines.items():
        serve_trace(eng, images)  # first use of each bucket (captures)
        reset_launch_counts()
        reqs, _, _ = serve_trace(eng, images)
        counts[name] = fired(launch_counts())
        logits[name] = np.stack([r.logits for r in reqs])
        lat[name] = {}
        rps[name] = []
    if not np.array_equal(logits["captured"], logits["eager"]):
        raise AssertionError("captured logits differ from the eager engine's")
    if counts["captured"] != counts["eager"] or counts["captured"]["digc_topk"] != 72:
        raise AssertionError(f"launches {counts}")
    print(f"phase-4 trace: captured logits bit for bit the eager engine's; "
          f"launches captured {counts['captured']}, eager {counts['eager']}")
    for _ in range(3):
        for name in ("captured", "eager", "eager", "captured"):
            _, ticks, sec = serve_trace(engines[name], images)
            rps[name].append(20 / sec)
            for b, v in ticks.items():
                lat[name].setdefault(b, []).extend(v)
    for name in engines:
        print(f"{name}: requests/s {', '.join(f'{v:.2f}' for v in rps[name])} "
              f"(median {statistics.median(rps[name]):.2f}); median tick by "
              f"bucket: " + ", ".join(
                  f"{b}: {statistics.median(v):.3f} ms ({len(v)} ticks)"
                  for b, v in sorted(lat[name].items())))
    # Profiled bucket-8 ticks in turns: eight new tenants (admission
    # evicts, parks and resets eight slots), then the same eight again.
    # A replay's launch counts are its capture's tally: each profiled
    # replay must show the device running as many DIGC and MRConv kernels.
    # The profiler can lose a tick's kernel records (an eager tick once
    # showed 11 of its 12 counted launches of each), so a replay it saw
    # short is profiled again, at most twice, and each shortfall printed.
    want = {"digc_topk": 12, "mrconv": 12}
    tally = engines["captured"]._captured[8].tally
    if fired(tally) != want:
        raise AssertionError(f"bucket-8 capture tally {tally}")
    for i, name in enumerate(("captured", "eager", "eager", "captured")):
        for kind in ("eight new tenants", "the same eight again"):
            print(f"{name}, {kind}:")
            got = profile_tick(engines[name], images, tag=f"q{i}_")
            for _ in range(2):
                if name == "eager" or got["on_device"] == want:
                    break
                print(f"the profiler saw {got['on_device']} of the replay's "
                      "kernels; profiling the same eight again")
                got = profile_tick(engines[name], images, tag=f"q{i}_")
            if got["counted"] != want or (name == "captured"
                                          and got["on_device"] != want):
                raise AssertionError(f"{name} bucket-8 tick: counted "
                                     f"{got['counted']}, on the device "
                                     f"{got['on_device']}, want {want}")
    print(f"bucket-8 capture tally {fired(tally)}: each profiled replay ran "
          "as many DIGC and MRConv kernels on the device")
    for name, eng in engines.items():
        assert_no_faults(eng, f"phase 18, {name}")
    # Phase 15's trace under capture against the eager engine, per policy.
    frames = video_frames(cfg.image_size)
    off = DigcSpec(impl="blocked", k=cfg.k)
    policies = {"off": off, **specs}
    ms: dict = {}
    for name, spec in policies.items():
        runs = {}
        for cls in (VigServeEngine, EagerEngine, EagerEngine, VigServeEngine):
            eng = cls(cfg, params, digc_impl=spec, autotune=False,
                      buckets=(1, 2, 4, 8, 16), device=DEV)
            res = serve_video(eng, frames)
            assert_no_faults(eng, f"phase 18, {name}")
            key = "captured" if cls is VigServeEngine else "eager"
            ms.setdefault((name, key), []).extend(res["ms"][1:])
            runs[key] = res
        cap, eag = runs["captured"], runs["eager"]
        for reqs, ereqs in zip(cap["reqs"], eag["reqs"]):
            for r, e in zip(reqs, ereqs):
                if not np.array_equal(r.logits, e.logits):
                    raise AssertionError(f"{name} request {r.uid}: captured "
                                         "logits differ from the eager engine's")
        if any(cap["reads"][1:]):
            raise AssertionError(f"{name}: gate reads on captured ticks "
                                 f"{cap['reads']}")
        print(f"phase-15 trace, {name}: captured bit for bit the eager "
              f"engine; gate reads a tick captured {cap['reads']}, eager "
              f"{eag['reads']}; median tick (ticks 2-{VIDEO_FRAMES}, two "
              f"passes each) "
              f"captured {statistics.median(ms[(name, 'captured')]):.3f} ms, "
              f"eager {statistics.median(ms[(name, 'eager')]):.3f} ms")


# Phase 19's lattice: vig_ti_iso at three image sizes (N = 100, 196 and
# 784; at 448 k ramps to 18 and the dilations to 2-6, kd 36-108),
# and the ragged waves of (tenant, size) it serves on 8 slots: tenants at
# two sizes, an eleventh tenant that evicts (parking every allocated
# size's rows) and the evicted tenant's return.
LATTICE_SIZES = (160, 224, 448)
LATTICE_WAVES = [
    [(f"t{i}", 224) for i in range(8)],
    [("t0", 448), ("t1", 448), ("t2", 448)],
    [("t3", 160), ("t4", 160)],
    [("t8", 224)],
    [("t5", 448)],
    [("t0", 160), ("t1", 160), ("t2", 160), ("t3", 160), ("t4", 160),
     (None, 160)],
    [("t1", 224), ("t2", 224)],
    [("t6", 448), ("t7", 448), ("t8", 448), ("t5", 448)],
]


def serve_cells(eng, waves: list, images) -> list:
    """Submit each wave and serve it to the end (a wave of several cells
    takes a tick per cell). ``images(uid, size)`` gives a request's
    image. Returns per tick: (size, bucket, requests in slot order, the
    launch counts the tick added, host-clock ms)."""
    ticks, uid = [], 0
    for wave in waves:
        reqs = []
        for tenant, size in wave:
            reqs.append(VigRequest(uid, images(uid, size), tenant=tenant))
            eng.submit(reqs[-1])
            uid += 1
        while eng.queue:
            before = launch_counts()
            waiting = [r for r in reqs if not r.done]
            s = time.perf_counter()
            eng.step()
            ms = (time.perf_counter() - s) * 1e3
            after = launch_counts()
            served = [r for r in waiting if r.done]
            order, bucket = bucket_batch(eng, served)
            ticks.append((eng.last_cell[0], bucket, order,
                          {k: after[k] - before[k] for k in after}, ms))
    return ticks


def steady_cell_ticks(eng, sizes, buckets, rounds: int = 3,
                      per_turn: int = 4) -> dict:
    """Median host-clock ms of a steady tick of each (size, bucket) cell:
    the same ``bucket`` tenants every tick, the cells taken in turns
    (forward, then backward)."""
    cells = [(s, b) for s in sizes for b in buckets]
    imgs = {s: [testing.images(5000 + i, 1, s)[0] for i in range(max(buckets))]
            for s in sizes}

    def tick(cell):
        size, bucket = cell
        for i in range(bucket):
            eng.submit(VigRequest(9000 + i, imgs[size][i], tenant=f"p{i}"))
        s = time.perf_counter()
        eng.step()
        if eng.last_cell != cell:
            raise AssertionError(f"served {eng.last_cell}, expected {cell}")
        return (time.perf_counter() - s) * 1e3

    for cell in cells:  # first use of each cell (captures)
        tick(cell)
    ms: dict = {c: [] for c in cells}
    for _ in range(rounds):
        for cell in cells + cells[::-1]:
            ms[cell] += [tick(cell) for _ in range(per_turn)]
    return {c: statistics.median(v) for c, v in ms.items()}


def lattice_serving() -> dict:
    """Returns the timed pass's DIGC (and MRConv) launches by node count."""
    phase("19. the (B, N) lattice: vig_ti_iso at 160^2, 224^2 and 448^2 on "
          "the cuda tier, a padded blocked cell, vig_ti_pyr off its grid")
    cfg = vig.VIG_VARIANTS["vig_ti_iso"]
    params = convert.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                 device=DEV)
    for size in LATTICE_SIZES:
        plans = vig.vig_stage_plans(cfg, "cuda", grid=size // cfg.patch)
        kds = sorted({k * d for p in plans
                      for k, d in zip(p.k_effs, p.dilations)})
        print(f"{size}^2: N = M = {plans[0].n}, k {plans[0].spec.k}, "
              f"dilations {list(plans[0].dilations)}, kd {kds}")
    images = {}

    def image(uid, size):
        return images.setdefault((uid, size),
                                 testing.images(3000 + uid, 1, size)[0])

    eng = VigServeEngine(cfg, params, digc_impl="cuda",
                         image_sizes=LATTICE_SIZES, device=DEV)
    serve_cells(eng, LATTICE_WAVES, image)  # first use of each cell
    reset_launch_counts()
    ticks = serve_cells(eng, LATTICE_WAVES, image)
    counts = fired(launch_counts())
    stats = eng.stats()
    print(f"stats: {json.dumps({k: stats[k] for k in ('cell_ticks', 'compile_count', 'parked_tenants', 'park_hits', 'park_evictions', 'padded_lanes', 'live_lanes')})}")
    assert_no_faults(eng, "phase 19")
    n_cells = len(eng.buckets) * len(eng.image_sizes)
    if not stats["compile_count"] == len(eng._captured) <= n_cells:
        raise AssertionError(f"{stats['compile_count']} programs, "
                             f"{sorted(eng._captured)}, bound {n_cells}")
    per_n: dict = {}
    for size, bucket, order, added, _ in ticks:
        if fired(added) != {"digc_topk": 12, "mrconv": 12}:
            raise AssertionError(f"({size}, {bucket}) tick launched {added}")
        n = (size // cfg.patch) ** 2
        per_n[n] = per_n.get(n, 0) + 12
    want = 12 * len(ticks)
    if counts != {"digc_topk": want, "mrconv": want} or sorted(per_n) != [100, 196, 784]:
        raise AssertionError(f"launches {counts} over {len(ticks)} ticks, by "
                             f"N {per_n}")
    if not eng.park_hits or not any(isinstance(p, dict) and len(p) > 1
                                    for p in eng._parked.values()):
        raise AssertionError(f"parking: hits {eng.park_hits}, parked "
                             f"{ {t: sorted(p) for t, p in eng._parked.items()} }")
    print(f"timed pass: {len(ticks)} ticks over cells "
          f"{sorted({(s, b) for s, b, *_ in ticks})}; launches {counts}, DIGC "
          f"and MRConv each by N {per_n}; parked "
          f"{ {t: sorted(p) for t, p in eng._parked.items()} }")
    check_bucket_forwards(params, cfg, "cuda", [(o, b) for _, b, o, _, _ in ticks])
    print(f"every request's logits bit for bit an eager forward of its cell's "
          f"batch ({sum(len(t[2]) for t in ticks)} requests)")
    # Each cell's kernels against their plain versions on the features
    # of its first tick in the timed pass.
    for cell in sorted({(s, b) for s, b, *_ in ticks}):
        first = next(t for t in ticks if t[:2] == cell)
        capture: list = []
        with torch.inference_mode():
            vig.vig_forward(params, to_dev(stack_batch(first[2], cell[1])),
                            cfg, digc_impl="cuda", digc_capture=capture)
        print(f"cell {cell}: ", end="")
        check_layers(capture, vig.vig_stage_plans(cfg, "cuda",
                                                  grid=cell[0] // cfg.patch))
    med = steady_cell_ticks(eng, LATTICE_SIZES, eng.buckets)
    print("steady tick by (size, bucket) cell, median of 24 in turns: "
          + ", ".join(f"{s}x{b} {m:.3f} ms" for (s, b), m in med.items()))
    profiles = {}
    for size in LATTICE_SIZES:
        print(f"profiled steady bucket-8 tick at {size}^2:")
        imgs = [testing.images(5000 + i, 1, size)[0] for i in range(8)]
        profiles[size] = profile_tick(eng, imgs, tag="p")
        if profiles[size]["counted"] != {"digc_topk": 12, "mrconv": 12}:
            raise AssertionError(f"{size}^2 profiled tick {profiles[size]}")
    assert_no_faults(eng, "phase 19 timing")
    padded_cell()
    pyramid_lattice()
    return per_n


def padded_cell() -> None:
    """192^2 and 320^2 requests padded up to the 224 and 448 cells of a
    blocked-tier engine (the kernel tier takes no mask): bit for bit a
    masked eager forward of each tick's batch, and no pad node in any
    row's top-k."""
    cfg = vig.VIG_VARIANTS["vig_ti_iso"]
    params = convert.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                 device=DEV)
    eng = VigServeEngine(cfg, params, digc_impl="blocked", autotune=False,
                         image_sizes=(224, 448), device=DEV)
    waves = [[("a", 192), ("b", 192), ("c", 320)],
             [("a", 192), ("c", 320), ("d", 320)],
             [("b", 224), ("e", 192)]]
    images = {}

    def image(uid, size):
        return images.setdefault((uid, size),
                                 testing.images(4000 + uid, 1, size)[0])

    serve_cells(eng, waves, image)  # first use of each cell
    ticks = serve_cells(eng, waves, image)
    spec = vig.resolve_digc_spec(cfg, "blocked")
    pad_ticks = 0
    for size, bucket, order, added, _ in ticks:
        if fired(added):
            raise AssertionError(f"the blocked tier launched {added}")
        canv, masks = [], []
        for r in order:
            h = r.image.shape[0]
            c = np.zeros((size, size, 3), np.float32)
            c[:h, :h] = r.image
            canv.append(c)
            m = np.zeros((size // cfg.patch,) * 2, bool)
            m[:h // cfg.patch, :h // cfg.patch] = True
            masks.append(m.reshape(-1))
        padded = any(r.image.shape[0] < size for r in order)
        pad = bucket - len(order)
        batch = to_dev(np.stack(canv + [canv[0]] * pad))
        mask = to_dev(np.stack(masks + [masks[0]] * pad)) if padded else None
        capture: list = []
        with torch.inference_mode():
            ref = vig.vig_forward(params, batch, cfg, digc_impl="blocked",
                                  valid_mask=mask, digc_capture=capture)
        ref = ref.cpu().numpy()
        for i, r in enumerate(order):
            if not np.array_equal(r.logits, ref[i]):
                raise AssertionError(
                    f"padded request {r.uid} ({r.image.shape[0]} -> {size}): "
                    f"logits differ from the masked eager forward by "
                    f"{float(np.abs(r.logits - ref[i]).max())}")
        if mask is None:
            continue
        pad_ticks += 1
        plan = vig.vig_stage_plans(cfg, "blocked", grid=size // cfg.patch)[0]
        for (_, h, _), k, dil in zip(capture, plan.k_effs, plan.dilations):
            with torch.inference_mode():
                idx, dist = digc(h, spec=spec.replace(k=k, dilation=dil),
                                 m_valid=mask, return_dists=True)
            live_nb = torch.gather(mask, 1, idx.reshape(idx.shape[0], -1).long())
            if not bool(live_nb.all()):
                raise AssertionError(f"a pad node entered a top-k at {size}^2")
            # the live rows' lists equal a build over the live nodes alone
            for b in range(len(order)):
                keep = mask[b].nonzero().squeeze(1)
                with torch.inference_mode():
                    li, ld = digc(h[b:b + 1, keep], spec=spec.replace(
                        k=k, dilation=dil), return_dists=True)
                testing.assert_topk_match(
                    idx[b:b + 1, keep].cpu().numpy(), dist[b:b + 1, keep].cpu().numpy(),
                    keep[li.long()].cpu().numpy(), ld.cpu().numpy(),
                    rtol=RTOL, atol=ATOL)
    assert_no_faults(eng, "phase 19, padded cell")
    if not pad_ticks or not any(len(k) == 3 for k in eng._captured):
        raise AssertionError(f"no padded cell served: {sorted(eng._captured, key=str)}")
    print(f"padded cells {sorted((k for k in eng._captured if len(k) == 3))}: "
          f"{sum(len(t[2]) for t in ticks)} requests bit for bit a masked "
          f"eager forward; in {pad_ticks} padded ticks every neighbour of "
          f"every row is a live node, and the live rows' lists equal a build "
          f"over the live nodes alone")


def pyramid_lattice() -> None:
    """One tick of vig_ti_pyr at 192^2, 224^2 and 256^2 (its positional
    embedding shrunk 56 -> 48 and grown 56 -> 64) on the cuda tier."""
    cfg = vig.VIG_VARIANTS["vig_ti_pyr"]
    params = convert.init_params(cfg, generator=torch.Generator().manual_seed(1),
                                 device=DEV)
    eng = VigServeEngine(cfg, params, digc_impl="cuda",
                         image_sizes=(192, 224, 256), device=DEV)
    waves = [[("a", 192), ("b", 192)], [("a", 224)], [("a", 256), ("c", 256)]]
    reset_launch_counts()
    ticks = serve_cells(eng, waves, lambda uid, s: testing.images(
        6000 + uid, 1, s)[0])
    blocks = sum(cfg.depths)
    for size, bucket, order, added, ms in ticks:
        if fired(added) != {"digc_topk": blocks, "mrconv": blocks}:
            raise AssertionError(f"pyr ({size}, {bucket}) launched {added}")
        print(f"pyr {size}^2, bucket {bucket}: stage N "
              f"{[p.n for p in vig.vig_stage_plans(cfg, 'cuda', grid=size // 4)]}, "
              f"first tick (captures) {ms:.1f} ms")
    check_bucket_forwards(params, cfg, "cuda", [(o, b) for _, b, o, _, _ in ticks])
    assert_no_faults(eng, "phase 19, pyr")
    print(f"vig_ti_pyr: {len(ticks)} ticks bit for bit eager forwards of "
          f"their batches, {blocks} DIGC and MRConv launches a tick")


SCHED_SLO = {"gold": 20.0, "default": 80.0}


def sched_engine(cfg, params, **kw):
    """Phase 20's engine: the kernel tier at 224^2 and 448^2 on 4 slots."""
    return VigServeEngine(cfg, params, digc_impl="cuda", buckets=(1, 2, 4),
                          image_sizes=(224, 448), device=DEV, **kw)


def stamped_replay(eng, trace, images, clock) -> tuple[list, list]:
    """``replay`` with each request recorded and stamped with the clock's
    time when its logits reached the host. Returns (requests, ticks)."""
    reqs: list = []
    submit, step = eng.submit, eng.step

    def submit_rec(req):
        submit(req)
        reqs.append(req)

    def step_rec():
        n = step()
        now = clock.now()
        for r in reqs:
            if r.done and not hasattr(r, "_done_t"):
                r._done_t = now
        return n

    eng.submit, eng.step = submit_rec, step_rec
    ticks = replay(eng, trace, images, clock=clock)
    return reqs, ticks


def wall_replay(eng, trace, images) -> tuple[list, float]:
    """The trace on the wall clock: sleep to each arrival, submit, offer
    a tick, wake at each admission deadline between arrivals, drain.
    Returns the requests, stamped when their logits reached the host,
    and the seconds the replay took."""
    reqs: list = []

    def tick():
        eng.step()
        now = time.monotonic()
        for r in reqs:
            if r.done and not hasattr(r, "_done_t"):
                r._done_t = now

    t0 = time.monotonic()
    for uid, arr in enumerate(trace):
        t_arr = t0 + arr.t_ms / 1e3
        while eng.queue:
            dl = eng.next_deadline()
            if dl is None or dl >= t_arr:
                break
            time.sleep(max(0.0, dl - time.monotonic()))
            tick()
        time.sleep(max(0.0, t_arr - time.monotonic()))
        reqs.append(VigRequest(uid, images[arr.tenant], tenant=arr.tenant,
                               tclass=arr.tclass))
        eng.submit(reqs[-1])
        tick()
    while eng.queue:
        dl = eng.next_deadline()
        if dl is not None:
            time.sleep(max(0.0, dl - time.monotonic()))
        tick()
    return reqs, time.monotonic() - t0


def scheduler_phase() -> None:
    phase("20. SLO admission: arrival_trace(seed=0, 8 tenants, gold/default, "
          "224/448) on captured cuda-tier programs")
    cfg = vig.VIG_VARIANTS["vig_ti_iso"]
    params = convert.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                 device=DEV)
    trace = arrival_trace(seed=0, tenants=8, classes=("gold", "default"),
                          sizes=(224, 448))
    sizes = {a.tenant: a.size for a in trace}
    images = {t: testing.images(7000 + int(t[1:]), 1, s)[0]
              for t, s in sizes.items()}
    runs = {}
    for name, kw in (("sched", dict(slo_ms=SCHED_SLO)),
                     ("sched_noprefetch", dict(slo_ms=SCHED_SLO, prefetch=False)),
                     ("slo0", dict(slo_ms=0.0)), ("legacy", {})):
        clock = VirtualClock()
        eng = sched_engine(cfg, params, **kw, **({"clock": clock} if kw else {}))
        reqs, ticks = stamped_replay(eng, trace, images, clock)
        assert_no_faults(eng, f"phase 20, {name}")
        runs[name] = (eng, reqs, ticks)
    eng, reqs, ticks = runs["sched"]
    late = [r.uid for r in reqs
            if r._done_t > r._enq_t + eng._slo_s(r) + 1e-9]
    order: dict = {}
    for r in sorted(reqs, key=lambda r: (r._done_t, r.uid)):
        order.setdefault(r.tenant, []).append(r.uid)
    if late or any(u != sorted(u) for u in order.values()):
        raise AssertionError(f"deadline misses {late}; order {order}")
    st = eng.stats()
    if st["padded_lanes"] != sum(w - live for _, live, w in ticks):
        raise AssertionError(f"padded lanes {st['padded_lanes']}, ticks {ticks}")
    if not st["prefetch_hits"] or not st["deferrals"]:
        raise AssertionError(f"prefetch {st['prefetch_issued']} / "
                             f"{st['prefetch_hits']}, deferrals {st['deferrals']}")
    for a, b, what in (("sched", "sched_noprefetch", "prefetch=False"),
                       ("slo0", "legacy", "the legacy engine")):
        for r, s in zip(runs[a][1], runs[b][1]):
            if r.logits.tobytes() != s.logits.tobytes():
                raise AssertionError(f"{a} request {r.uid}: logits differ from "
                                     f"{what}'s")
    leg = runs["legacy"][0].stats()
    print(f"virtual clock: {len(reqs)} requests in {len(ticks)} ticks, "
          f"deferrals {st['deferrals']}, every deadline held, each tenant in "
          f"order; padded lanes {st['padded_lanes']} (= sum of width - live), "
          f"util {st['util']:.3f}; prefetch issued {st['prefetch_issued']}, "
          f"hits {st['prefetch_hits']}, park hits {st['park_hits']}; cells "
          f"{st['cell_ticks']}; logits bit for bit prefetch=False; slo_ms=0 "
          f"bit for bit the legacy engine ({leg['padded_lanes']} padded lanes "
          f"in {sum(leg['bucket_ticks'].values())} ticks)")
    # The same trace on the wall clock, slo_ms against slo_ms=0, in turns.
    wall = {"sched": sched_engine(cfg, params, slo_ms=SCHED_SLO),
            "slo0": sched_engine(cfg, params)}
    for e in wall.values():
        wall_replay(e, trace, images)  # first use of each cell (captures)
    out: dict = {k: {"rps": [], "padded": [], "lat": {}} for k in wall}
    for name in ("sched", "slo0", "slo0", "sched"):
        e = wall[name]
        padded = e.padded_lanes
        got, sec = wall_replay(e, trace, images)
        out[name]["rps"].append(len(got) / sec)
        out[name]["padded"].append(e.padded_lanes - padded)
        for r in got:
            out[name]["lat"].setdefault(r.tclass, []).append(
                (r._done_t - r._enq_t) * 1e3)
    for name, e in wall.items():
        assert_no_faults(e, f"phase 20 wall, {name}")
        o = out[name]
        lat = ", ".join(
            f"{c} p50 {np.percentile(v, 50):.2f} ms p99 {np.percentile(v, 99):.2f} ms"
            for c, v in sorted(o["lat"].items()))
        print(f"wall clock, {name}: requests/s "
              f"{', '.join(f'{v:.2f}' for v in o['rps'])}; padded lanes "
              f"{o['padded']}; admission to logits {lat}")


# Phase 21: the approximate tiers (cluster, axial) at the lattice's 224^2
# and 448^2 cells of vig_ti_iso (N = 196 with 7 clusters at full probe;
# N = 784 with 28 clusters, 8 probed).
APPROX_SIZES = (224, 448)
APPROX_WAVES = [
    [(f"t{i}", 448) for i in range(8)],
    [("t0", 224), ("t1", 224), ("t2", 448)],
    [(f"t{i}", 448) for i in range(8)],
    [("t8", 448)],
    [(f"t{i}", 224) for i in range(8)],
]


def exact_clusters(seed: int, b: int, m: int, d: int, n_clusters: int,
                   perm: np.ndarray) -> np.ndarray:
    """(b, m, d) co-nodes whose cluster index has no near-tie: m /
    n_clusters integer points around each of n_clusters centres (integer
    multiples of 10 per axis) with offsets in {-1, 0, 1} that cancel in
    pairs, and the cold start's permutation rows (``perm[:n_clusters]``)
    one in each cluster. The first Lloyd step then finds the clusters,
    every centroid is its integer centre exactly and every distance is an
    exact integer in any summation order, so the card and the CPU must
    agree bit for bit; ties go to the lowest index on both."""
    rng = np.random.default_rng(seed)
    size = m // n_clusters
    out = np.empty((b, m, d), np.float32)
    for i in range(b):
        lab = np.empty(m, np.int64)
        lab[perm[:n_clusters]] = np.arange(n_clusters)
        rest = np.setdiff1d(np.arange(m), perm[:n_clusters])
        lab[rest] = rng.permutation(np.repeat(np.arange(n_clusters), size - 1))
        centres = rng.integers(-3, 4, (n_clusters, d)) * 10
        for c in range(n_clusters):
            half = rng.integers(-1, 2, (size // 2, d))
            out[i, lab == c] = centres[c] + rng.permutation(
                np.concatenate([half, -half]))
    return out


def captured_ms(fn) -> float:
    """Device ms of one call of ``fn`` captured as a CUDA graph, its
    replays timed by ``time_ms``: a function of a few hundred small
    launches, called directly, fills the launch queue and is paced by the
    host however long the device is held."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay)[0]


def device_launches(fn) -> tuple[int, int]:
    """(operations the device ran, host launch calls) in one call of
    ``fn``, by torch.profiler after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    ran = sum(e.count for e in events if str(e.device_type).endswith("CUDA"))
    calls = sum(e.count for e in events
                if not str(e.device_type).endswith("CUDA")
                and e.key.startswith("cuda") and "Launch" in e.key)
    return ran, calls


def neighbour_recall(a: torch.Tensor, b: torch.Tensor) -> float:
    """Mean share of each row of ``b`` (..., k) that ``a`` holds."""
    a = a.reshape(-1, a.shape[-1]).cpu().numpy()
    b = b.reshape(-1, b.shape[-1]).cpu().numpy()
    return float(np.mean([len(set(x) & set(y)) / len(y) for x, y in zip(a, b)]))


def approx_calls() -> None:
    """(a): each tier on the card against the same function on the CPU at
    B = 8, the main-path kd of each size, with device ms and launches per
    call beside the cuda kernel's."""
    cfg = vig.VIG_VARIANTS["vig_ti_iso"]
    d = cfg.embed_dims[0]
    for size in APPROX_SIZES:
        plan = vig.vig_stage_plans(cfg, "cluster", grid=size // cfg.patch)[0]
        n = plan.n
        kds = sorted({k * dil for k, dil in zip(plan.k_effs, plan.dilations)})
        n_clusters, n_probe = strategies.default_cluster_params(n, None, None)
        y = exact_clusters(size, 8, n, d, n_clusters,
                           prng.permutation(0, n, "cpu").numpy())
        x, xc = to_dev(y), torch.from_numpy(y)
        for kd in kds:
            got = strategies.cluster_digc(x, k=kd, return_dists=True,
                                          return_state=True)
            want = strategies.cluster_digc(xc, k=kd, return_dists=True,
                                           return_state=True)
            init = got[2]["centroids"]
            valid = torch.tensor([True, False] * 4)
            got_w = strategies.cluster_digc(
                x, k=kd, init_centroids=init, init_valid=valid.to(DEV),
                return_dists=True)
            want_w = strategies.cluster_digc(
                xc, k=kd, init_centroids=init.cpu(), init_valid=valid,
                return_dists=True)
            for g, w in ((got[:2], want[:2]), (got_w, want_w)):
                if not (torch.equal(g[0].cpu(), w[0]) and torch.equal(g[1].cpu(), w[1])):
                    raise AssertionError(f"cluster_digc N={n} kd={kd}: the card "
                                         "differs from the CPU")
            if not torch.equal(init.cpu(), want[2]["centroids"]):
                raise AssertionError(f"cluster_digc N={n}: centroids differ")
            # Captured, a call with a warm/cold flag builds both indexes.
            all_warm = torch.ones(8, dtype=torch.bool, device=DEV)
            cold_ms = captured_ms(lambda: strategies.cluster_digc(x, k=kd))
            warm_ms = captured_ms(lambda: strategies.cluster_digc(
                x, k=kd, init_centroids=init, kmeans_iters=2))
            mixed_ms = captured_ms(lambda: strategies.cluster_digc(
                x, k=kd, init_centroids=init, init_valid=all_warm))
            cuda_ms = time_ms(lambda: digc_topk_cuda(x, x, kd))[0]
            cold_ops = device_launches(lambda: strategies.cluster_digc(x, k=kd))
            warm_ops = device_launches(lambda: strategies.cluster_digc(
                x, k=kd, init_centroids=init, kmeans_iters=2))
            cuda_ops = device_launches(lambda: digc_topk_cuda(x, x, kd))
            recall = neighbour_recall(got[0], digc_topk_cuda(x, x, kd)[1])
            print(f"cluster_digc B=8 N={n} D={d} kd={kd} (C={n_clusters}, "
                  f"probe {n_probe}): card = CPU bit for bit, cold and per-row "
                  f"warm/cold; recall vs cuda {recall:.4f}; device ms "
                  f"(captured) cold {cold_ms:.4f}, warm {warm_ms:.4f}, read-"
                  f"free warm/cold choice {mixed_ms:.4f}; cuda kernel "
                  f"{cuda_ms:.4f}; device ops / host launch calls per call: "
                  f"cold {cold_ops}, warm {warm_ops}, cuda {cuda_ops}")
    plan = vig.vig_stage_plans(cfg, "axial")[0]
    side = cfg.base_grid
    x = to_dev(testing.features(21, 8, plan.n, d))
    xc = x.cpu()
    for kd in sorted({k * dil for k, dil in zip(plan.k_effs, plan.dilations)}):
        got = strategies.axial_digc(x, grid_h=side, grid_w=side, k=kd,
                                    return_dists=True)
        want = strategies.axial_digc(xc, grid_h=side, grid_w=side, k=kd,
                                     return_dists=True)
        live = want[1] < BIG / 2
        gi, gd = got[0].cpu(), got[1].cpu()
        if not (torch.equal(gd < BIG / 2, live) and torch.equal(gi[~live], want[0][~live])):
            raise AssertionError(f"axial kd={kd}: BIG lanes differ from the CPU")
        fill = -1 - torch.arange(kd, dtype=gi.dtype)
        testing.assert_topk_match(
            torch.where(live, gi, fill).numpy(), torch.where(live, gd, 0).numpy(),
            torch.where(live, want[0], fill).numpy(),
            torch.where(live, want[1], 0).numpy(), rtol=RTOL, atol=ATOL)
        ax_ms = captured_ms(lambda: strategies.axial_digc(
            x, grid_h=side, grid_w=side, k=kd))
        cuda_ms = time_ms(lambda: digc_topk_cuda(x, x, kd))[0]
        ops = device_launches(lambda: strategies.axial_digc(
            x, grid_h=side, grid_w=side, k=kd))
        recall = neighbour_recall(got[0], digc_topk_cuda(x, x, kd)[1])
        print(f"axial_digc B=8 N={plan.n} D={d} kd={kd}: card = CPU except at "
              f"near-ties ({int((gi != want[0]).sum())} swaps); recall vs cuda "
              f"{recall:.4f}; device ms (captured) {ax_ms:.4f} (cuda kernel "
              f"{cuda_ms:.4f}); device ops / host launch calls {ops}")


def layer_recall(params, cfg, impl: str, size: int) -> list:
    """Per layer of one eager B = 8 forward through ``impl`` at ``size``:
    the share of the cuda kernel's neighbours (same features, same k and
    dilation) that the tier served."""
    plans = vig.vig_stage_plans(cfg, impl, grid=size // cfg.patch)
    geo = [(k, dil) for p in plans for k, dil in zip(p.k_effs, p.dilations)]
    capture: list = []
    images = to_dev(testing.images(size, 8, size))
    with torch.inference_mode():
        vig.vig_forward(params, images, cfg, digc_impl=impl, digc_capture=capture)
        out = []
        for (_, h, _), (k, dil) in zip(capture, geo):
            served = digc(h, spec=DigcSpec(impl=impl, k=k, dilation=dil).with_grid(
                size // cfg.patch, size // cfg.patch))
            exact = digc_topk_cuda(h, h, k * dil)[1][..., ::dil]
            out.append(neighbour_recall(served, exact))
    return out


def approx_serving() -> None:
    phase("21. the approximate tiers: cluster_digc and axial_digc against the "
          "CPU; a captured cluster engine at 224^2 and 448^2; cluster faults")
    approx_calls()
    cfg = vig.VIG_VARIANTS["vig_ti_iso"]
    params = convert.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                 device=DEV)
    for size in APPROX_SIZES:
        rec = layer_recall(params, cfg, "cluster", size)
        print(f"cluster tier at {size}^2, per layer recall vs cuda (B = 8 "
              f"forward): {[round(r, 4) for r in rec]}")
    rec = layer_recall(params, cfg, "axial", 224)
    print(f"axial tier at 224^2, per layer recall vs cuda: "
          f"{[round(r, 4) for r in rec]}")
    with torch.inference_mode():
        logits = vig.vig_forward(params, to_dev(testing.images(5, 8, 224)), cfg,
                                 digc_impl="axial")
    if logits.shape != (8, cfg.num_classes) or not torch.isfinite(logits).all():
        raise AssertionError("axial forward: bad logits")
    # (b) phase 4's trace at 224^2, then (tenant, size) waves over 224^2
    # and 448^2, captured against the eager engine.
    images = [testing.images(uid, 1, cfg.image_size)[0] for uid in range(20)]
    waves = {}

    def image(uid, size):
        return waves.setdefault((uid, size), testing.images(7000 + uid, 1, size)[0])

    runs = {}
    reset_launch_counts()
    for name, cls in (("captured", VigServeEngine), ("eager", EagerEngine)):
        eng = cls(cfg, params, digc_impl="cluster", device=DEV)
        reqs = serve_trace(eng, images)[0] + serve_trace(eng, images)[0]
        lat = cls(cfg, params, digc_impl="cluster", image_sizes=APPROX_SIZES,
                  device=DEV)
        ticks = serve_cells(lat, APPROX_WAVES, image) + serve_cells(
            lat, APPROX_WAVES, image)
        for e in (eng, lat):
            assert_no_faults(e, f"phase 21, {name}")
        runs[name] = (eng, reqs, lat, [r for t in ticks for r in t[2]])
    if fired(launch_counts()):
        raise AssertionError(f"the cluster path launched {fired(launch_counts())}")
    (ceng, creqs, clat, cwave), (eeng, ereqs, elat, ewave) = (
        runs["captured"], runs["eager"])
    for a, b in zip(creqs + cwave, ereqs + ewave):
        if not np.array_equal(a.logits, b.logits):
            raise AssertionError(f"request {a.uid}: captured cluster logits "
                                 "differ from the eager engine's")
    for c, e in ((ceng, eeng), (clat, elat)):
        for size in c._slot_states:
            got = c._slot_states[size].entries["stage0"].centroids
            if not torch.equal(got, e._slot_states[size].entries["stage0"].centroids):
                raise AssertionError(f"{size}^2: captured centroids differ")
    warm = {size: int((st.entries["stage0"].centroids.abs().sum((1, 2)) > 0).sum())
            for size, st in clat._slot_states.items()}
    if not all(warm.values()) or not ceng.park_hits:
        raise AssertionError(f"warm rows {warm}, park hits {ceng.park_hits}")
    print(f"phase-4 trace (2 passes) and {len(cwave) // 2} lattice requests "
          f"x 2: captured bit for bit the eager engine (logits and centroids); "
          f"programs captured {ceng.compile_count} + {clat.compile_count}; "
          f"slot rows warm by size {warm}; row steps 224^2 "
          f"{ceng.slot_row_steps()['stage0']}; warm/cold reads captured "
          f"{ceng.gate_reads + clat.gate_reads}, eager "
          f"{eeng.gate_reads + elat.gate_reads}; park hits {ceng.park_hits}; "
          "no DIGC or MRConv kernel launched")
    # Steady bucket-8 ticks, cluster and cuda engines in turns.
    engines = {impl: VigServeEngine(cfg, params, digc_impl=impl, buckets=(8,),
                                    image_sizes=APPROX_SIZES, device=DEV)
               for impl in ("cluster", "cuda")}
    imgs = {s: [testing.images(5000 + i, 1, s)[0] for i in range(8)]
            for s in APPROX_SIZES}
    ms: dict = {}

    def tick(eng, size):
        for i in range(8):
            eng.submit(VigRequest(9000 + i, imgs[size][i], tenant=f"p{i}"))
        s = time.perf_counter()
        eng.step()
        return (time.perf_counter() - s) * 1e3

    for impl in engines:
        for size in APPROX_SIZES:
            tick(engines[impl], size)
    for _ in range(2):
        for impl in ("cluster", "cuda", "cuda", "cluster"):
            for size in APPROX_SIZES:
                ms.setdefault((impl, size), []).extend(
                    tick(engines[impl], size) for _ in range(3))
    print("steady captured bucket-8 tick, median of 12 in turns: " + ", ".join(
        f"{impl} {size}^2 {statistics.median(v):.3f} ms"
        for (impl, size), v in sorted(ms.items())))
    for size in APPROX_SIZES:
        for impl, eng in engines.items():
            print(f"profiled steady bucket-8 tick, {impl} at {size}^2:")
            profile_tick(eng, imgs[size], tag="p")
    for eng in engines.values():
        assert_no_faults(eng, "phase 21 timing")
    approx_faults(cfg, params)


def approx_faults(cfg, params) -> None:
    """(c): a centroid bitflip recovers cold with the co-batched lanes bit
    for bit the fault-free run; a persistent cluster build failure walks
    the ladder to blocked."""
    tenants = ("A", "B", "C")
    frames = {(t, i): testing.images(8000 + 10 * t + i, 1, cfg.image_size)[0]
              for t in range(4) for i in range(3)}

    def run(plan=None, **kw):
        eng = VigServeEngine(cfg, params, digc_impl="cluster", buckets=(4,),
                             fault_plan=plan, device=DEV, **kw)
        reqs = {}
        for t in range(4):
            for i, n in enumerate(tenants):
                reqs[(t, n)] = r = VigRequest(10 * t + i, frames[(t, i)], tenant=n)
                eng.submit(r)
            eng.step()
        return eng, reqs

    clean_eng, clean = run()
    assert_no_faults(clean_eng, "phase 21 fault-free run")
    plan = FaultPlan(seed=3).inject_state_corruption(
        field="centroids", row=1, tick=2, mode="bitflip")
    eng, reqs = run(plan)
    st = eng.stats()
    if not (plan.counts() == {"state_corruption": 1} and st["quarantines"] == 0
            and st["state_resets"] >= 1 and st["fallback_level"] == 0
            and [f["kind"] for f in st["faults"]] == ["state_corruption"]):
        raise AssertionError(f"centroid bitflip: {fault_counters(eng)}")
    for key, r in reqs.items():
        if key[1] != "B" and not np.array_equal(r.logits, clean[key].logits):
            raise AssertionError(f"{key}: logits differ from the fault-free run")
    print(f"centroid bitflip ({plan.fired[0].detail}): detected, B served "
          f"cold, A and C bit for bit the fault-free run; {fault_counters(eng)}")
    plan = FaultPlan(seed=5).inject_build_failure(impl="cluster", times=None)
    eng, reqs = run(plan, retry_backoff=0.0)
    st = eng.stats()
    if (st["fallback_level"], st.get("fallback_impl")) != (1, "blocked") or any(
            r.logits is None or not np.isfinite(r.logits).all()
            for r in reqs.values()):
        raise AssertionError(f"build-failure ladder: {fault_counters(eng)}")
    print(f"persistent cluster build failure: the ladder serves on "
          f"{st['fallback_impl']}; {fault_counters(eng)}")



# Phase 22: the LM served on the card. The card's fp32 logits against the
# CPU's: sums in other orders than cuBLAS's, whose rounding scales with
# the residual stream, not with the logits. The stacked layers' fan-in
# init takes shape[0], the layer count, as JAX's does, so at 2 layers the
# residual grows to ~1e4 times the logits' RMS before the final norm,
# and fp32's 1.2e-7 becomes ~1e-3 of the logits' RMS (the run prints the
# ratio). Tolerance: max |diff| <= LM_TOL_RMS x the CPU logits' RMS, and
# equal tokens.
LM_TOL_RMS = 1e-2


def profile_call(fn) -> dict:
    """``fn()`` once under torch.profiler: host-clock ms under the
    profiler, the device's busy ms (kernel time summed), host launch calls
    (runtime API calls named ``cuda*Launch*``) and device kernels; prints
    the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0)

    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    launches = sum(e.count for e in events
                   if not str(e.device_type).endswith("CUDA")
                   and e.key.startswith("cuda") and "Launch" in e.key)
    for e in sorted(kernels, key=dev_us, reverse=True)[:6]:
        print(f"  device {dev_us(e) / 1e3:8.3f} ms x{e.count:<4d} {e.key[:70]}")
    cpu = [e for e in events if not str(e.device_type).endswith("CUDA")]
    for e in sorted(cpu, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]:
        print(f"  host   {e.self_cpu_time_total / 1e3:8.3f} ms x{e.count:<4d} "
              f"{e.key[:70]}")
    return dict(wall_ms=wall_ms, busy_ms=sum(dev_us(e) for e in kernels) / 1e3,
                host_launches=launches, kernels=sum(e.count for e in kernels))


def tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in module.leaves(tree).values())


def check_tokens(finished, n_req: int, n_new: int, vocab: int) -> int:
    if len(finished) != n_req or any(
            len(r.out_tokens) != n_new or not all(0 <= t < vocab for t in r.out_tokens)
            for r in finished):
        raise AssertionError(f"{len(finished)} requests finished, expected "
                             f"{n_req} x {n_new} tokens in [0, {vocab})")
    return n_req * n_new


class FiniteEngine(ServeEngine):
    """The LM engine with every decode step's member logits screened for
    finiteness on the card (one read at the end) and ``run`` timed."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.finite = torch.ones((), dtype=torch.bool, device=self.device)

    def _step_decode(self, tokens, pos, members):
        logits = super()._step_decode(tokens, pos, members)
        self.finite &= torch.isfinite(logits[members]).all()
        return logits

    def run(self):
        t0 = time.perf_counter()
        out = super().run()
        torch.cuda.synchronize()
        self.run_s = time.perf_counter() - t0
        return out


def served_tokens(eng: FiniteEngine, finished, counts: dict, n_req: int,
                  n_new: int, how: str) -> None:
    """Checks a served run (tokens in range, every logit finite, no kernel
    launched) and prints its tokens/s."""
    n_tok = check_tokens(finished, n_req, n_new, eng.cfg.vocab_size)
    if not bool(eng.finite) or fired(counts):
        raise AssertionError(f"finite logits {bool(eng.finite)}, kernel "
                             f"launches {fired(counts)} (none expected)")
    params = eng.params  # the compute-dtype tree
    n_params = sum(t.numel() for t in module.leaves(params).values())
    print(f"served through {how}: {n_tok} tokens, "
          f"{n_tok / eng.run_s:.1f} tokens/s over run() ({eng.run_s:.3f} s, "
          f"{eng.slots} slots), decode_calls {eng.decode_calls}; "
          f"{n_params / 1e9:.3f} B parameters held as "
          f"{sorted({str(t.dtype) for t in module.leaves(params).values()})} "
          f"({tensor_bytes(params) / 1e9:.3f} GB); every logit finite, no "
          "kernel launched")


def served_through_main(arch: str) -> FiniteEngine:
    """``launch.serve.main`` at full width on the card with its defaults (8
    requests, 16 prompt and 16 new tokens, 4 slots), through a
    ``FiniteEngine`` patched into ``launch.serve``; returns the engine."""
    engines: list = []

    class Kept(FiniteEngine):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            engines.append(self)

    lm_serve.ServeEngine = Kept
    try:
        reset_launch_counts()
        finished = lm_serve.main(["--arch", arch, "--device", "cuda"])
        counts = launch_counts()
    finally:
        lm_serve.ServeEngine = ServeEngine
    eng = engines.pop()  # no cycle through Kept's closure keeps it alive
    served_tokens(eng, finished, counts, 8, 16, "repro_torch.launch.serve.main")
    return eng


def timed_decode_step(eng: ServeEngine):
    """The engine's decode step at 4 active slots (4 new requests of 16
    prompt tokens prefilled): (ms by CUDA events over 20 steps, one
    profiled step, the slots' positions, the step)."""
    for uid in range(4):
        eng.submit(Request(100 + uid, np.random.default_rng(100 + uid).integers(
            0, eng.cfg.vocab_size, 16).astype(np.int32), max_new_tokens=20))
    eng.step()  # prefill the 4 slots, one batched decode
    toks = np.zeros((4, 1), np.int32)
    pos, members = eng.slot_pos.copy(), [0, 1, 2, 3]

    def step():
        ServeEngine._step_decode(eng, toks, pos, members)

    for _ in range(3):
        step()
    return _events_ms(step, 20), profile_call(step), pos, step


def step_line(step_ms: float, prof: dict, pos) -> str:
    return (f"decode step, 4 slots at position {int(pos[0])}: {step_ms:.3f} ms "
            f"(CUDA events, 20 steps); profiled: {prof['host_launches']} host "
            f"launch calls, {prof['kernels']} device kernels, device busy "
            f"{prof['busy_ms']:.3f} ms = {100 * prof['busy_ms'] / step_ms:.1f}% "
            "of the step")


def lm_serving() -> None:
    t_phase = time.perf_counter()
    phase("22. LM serving on the card: olmo-1b at full width")
    cfg = lm_configs.get_config("olmo-1b")
    eng = served_through_main("olmo-1b")
    params = eng.params
    n_params = sum(t.numel() for t in module.leaves(params).values())
    step_ms, prof, pos, _ = timed_decode_step(eng)
    t_cache = eng.cache["k"].shape[2]
    cache_bytes = tensor_bytes(eng.cache)
    flops = 2.0 * 4 * n_params + 4 * 4 * cfg.num_layers * cfg.num_heads * cfg.dh * t_cache
    bound_ms, by = bound(flops, tensor_bytes(params) + cache_bytes, PEAK_BF16_FLOPS)
    print(f"{step_line(step_ms, prof, pos)}; bound {bound_ms:.3f} ms ({by}: "
          f"{tensor_bytes(params) / 1e9:.3f} GB of bf16 weights + "
          f"{cache_bytes / 1e6:.1f} MB of cache read once)")
    engine_equals_greedy(cfg, params)
    fp32_prefill_decode(cfg.replace(dtype="float32"))
    card_equals_cpu(cfg.replace(dtype="float32", num_layers=2))
    lm_knn(cfg, params)
    print(f"phase 22 wall time: {time.perf_counter() - t_phase:.1f} s")


def greedy(params, cfg, prompt: np.ndarray, n_new: int, device):
    """A direct ``decode_step`` greedy loop over one batch of prompts
    (B, S): (tokens (B, n_new), the logits of every step, the cache)."""
    b, s = prompt.shape
    cache = tr.init_cache(cfg, b, s + n_new, device=device)
    cur = torch.from_numpy(prompt[:, :1]).to(device)
    out, logits = [], []
    for t in range(s + n_new - 1):
        lg, cache = tr.decode_step(params, cache, cur, t, cfg)
        logits.append(lg[:, 0].float().cpu())
        if t + 1 < s:
            cur = torch.from_numpy(prompt[:, t + 1:t + 2]).to(device)
        else:
            cur = lg[:, -1].argmax(-1, keepdim=True)
            out.append(cur[:, 0].cpu())
    return torch.stack(out, 1), torch.stack(logits, 1), cache


def engine_equals_greedy(cfg, params) -> None:
    """A slots=1 engine bit for bit a direct ``decode_step`` greedy loop:
    tokens and every cache entry (keys and values, or MLA's latents)."""
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, (1, 16)).astype(np.int32)
    one = ServeEngine(cfg, params, slots=1, max_len=24, device=DEV)
    one.submit(Request(0, prompt[0], max_new_tokens=8))
    got = one.run()[0].out_tokens
    toks, _, cache = greedy(params, cfg, prompt, 8, DEV)
    mine, theirs = module.leaves(one.cache), module.leaves(cache)
    if got != toks[0].tolist() or mine.keys() != theirs.keys() or not all(
            torch.equal(mine[k], theirs[k]) for k in theirs):
        raise AssertionError(f"slots=1 engine {got} against direct greedy "
                             f"{toks[0].tolist()} (or their caches differ)")
    print(f"slots=1 engine = direct decode_step greedy loop bit for bit "
          f"(tokens {got}, {len(theirs)} cache leaves equal: "
          f"{sorted({k[-1] for k in theirs})})")


def fp32_prefill_decode(cfg32) -> None:
    """In fp32 on the card, ``prefill`` + one ``decode_step`` against
    ``forward`` at JAX's tolerance (rtol 2e-3, atol 2e-4)."""
    p32 = module.init_params(tr.param_spec(cfg32), device=DEV,
                             generator=torch.Generator(device=DEV).manual_seed(1))
    tokens = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg32.vocab_size, (2, 16)).astype(np.int32)).to(DEV)
    with torch.inference_mode():
        full, _ = tr.forward(p32, tokens, cfg32)
        lp, cache = tr.prefill(p32, tokens[:, :-1], cfg32, max_len=16)
        lg, _ = tr.decode_step(p32, cache, tokens[:, -1:], 15, cfg32)
    for name, a, b in (("prefill", lp, full[:, :-1]), ("decode", lg[:, 0], full[:, -1])):
        err = float((a - b).abs().max())
        if not torch.allclose(a, b, rtol=2e-3, atol=2e-4):
            raise AssertionError(f"fp32 {name} against forward: max |diff| {err}")
        print(f"fp32 full width, {cfg32.num_layers} layers, {name} against "
              f"forward: max |diff| {err:.3g} (rtol 2e-3, atol 2e-4)")


def card_equals_cpu(cfg2, tol: float = LM_TOL_RMS) -> None:
    """At a few layers, full width, fp32: the card's greedy decode equals
    the CPU's (tokens equal, logits within ``tol`` of their RMS). Drawn on
    the card, copied to the host."""
    p_dev = module.init_params(tr.param_spec(cfg2), device=DEV,
                               generator=torch.Generator(device=DEV).manual_seed(2))
    p_cpu = module.map_tree(lambda _, t: t.cpu(), p_dev)
    prompt = np.random.default_rng(9).integers(0, cfg2.vocab_size, (2, 8)).astype(np.int32)
    with torch.inference_mode():
        t_cpu, l_cpu, _ = greedy(p_cpu, cfg2, prompt, 8, "cpu")
        t_dev, l_dev, _ = greedy(p_dev, cfg2, prompt, 8, DEV)
        x = p_cpu["embed"]["tokens"][torch.from_numpy(prompt).long()]
        pos = torch.arange(prompt.shape[1]).expand(prompt.shape)
        for i in range(cfg2.num_layers):
            kind, lp = tr._layer(p_cpu, i, cfg2)
            x, _, _ = tr._block(lp, x, cfg2, kind, positions=pos)
    err = float((l_dev - l_cpu).abs().max())
    rms = float(l_cpu.pow(2).mean().sqrt())
    if not torch.equal(t_dev, t_cpu) or err > tol * rms:
        raise AssertionError(f"{cfg2.num_layers} layers, fp32: card tokens "
                             f"{t_dev.tolist()}, CPU {t_cpu.tolist()}; max "
                             f"|logit diff| {err}, logit RMS {rms}")
    print(f"{cfg2.num_layers} layers, full width, fp32: card = CPU, tokens equal "
          f"({t_dev.shape[1]} new per row), max |logit diff| over "
          f"{l_dev.shape[1]} steps {err:.3g} = {err / rms:.3g} of the logits' "
          f"RMS {rms:.3g} (tolerance {tol}); the prompt's residual "
          f"stream before the final norm has RMS {float(x.pow(2).mean().sqrt()):.4g}")


def lm_knn(cfg, params) -> None:
    """(c): kNN attention at full width, 64 neighbours, past the cache's
    first 64 keys; then a 1024-token prefill through the blocked tier."""
    knn_cfg = cfg.replace(attention="knn", knn_neighbors=64)
    calls = [0]
    real = knn_attention.digc

    def counting_digc(*args, **kw):
        calls[0] += 1
        return real(*args, **kw)

    knn_attention.digc = counting_digc
    try:
        eng = ServeEngine(knn_cfg, params, slots=4, max_len=256 + 16 + 8, device=DEV)
        for uid in range(4):
            eng.submit(Request(uid, np.random.default_rng(200 + uid).integers(
                0, cfg.vocab_size, 256).astype(np.int32), max_new_tokens=16))
        reset_launch_counts()
        t0 = time.perf_counter()
        finished = eng.run()
        serve_s = time.perf_counter() - t0
        serve_counts = launch_counts()
        n_tok = check_tokens(finished, 4, 16, cfg.vocab_size)
        serve_calls, decode_calls = calls[0], eng.decode_calls
        toks = np.zeros((4, 1), np.int32)
        pos = np.full(4, 272, np.int32)
        decode_ms = _events_ms(
            lambda: ServeEngine._step_decode(eng, toks, pos, [0, 1, 2, 3]), 10)
        prompt = torch.from_numpy(np.random.default_rng(300).integers(
            0, cfg.vocab_size, (1, 1024)).astype(np.int32)).to(DEV)
        with torch.inference_mode():
            tr.prefill(params, prompt, knn_cfg)  # warm-up
            calls[0] = 0
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = tr.prefill(params, prompt, knn_cfg)
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
        prefill_counts, prefill_calls = launch_counts(), calls[0]
    finally:
        knn_attention.digc = real
    if (fired(serve_counts) or fired(prefill_counts) or serve_calls
            or prefill_calls != cfg.num_layers
            or not bool(torch.isfinite(logits).all())):
        raise AssertionError(
            f"kNN: launches {fired(serve_counts)} / {fired(prefill_counts)}, DIGC "
            f"calls serving {serve_calls} (decode sorts), prefill {prefill_calls} "
            f"(expected {cfg.num_layers}), finite {bool(torch.isfinite(logits).all())}")
    print(f"kNN attention (64 neighbours): 4 requests x 256 prompt tokens + 16 "
          f"new in {serve_s:.2f} s ({n_tok / serve_s:.1f} new tokens/s, "
          f"{decode_calls} decode calls, no DIGC call: decode sorts one "
          f"distance row a head); decode step at a 273-key cache {decode_ms:.3f} "
          f"ms (CUDA events); prefill of 1024 tokens at B = 1: {prefill_ms:.2f} ms "
          f"(host clock, after a warm-up), {prefill_calls} DIGC calls on the "
          f"blocked tier (one a layer, {cfg.num_heads} heads each), no kernel launched")


# Phase 23: the MoE family. deepseek-v2-lite-16b (MLA + MoE, 16.21 B
# parameters) is the one MoE arch a single card holds whole in bf16; the
# fp32 checks run at reduced depth after its engine is freed.
DEEPSEEK_FP32_LAYERS = 4


def routed_layers(step) -> list:
    """``step()`` once with ``models.moe._router`` recording each MoE
    layer's selected experts: the distinct experts of each layer."""
    routes, real = [], moe._router

    def record(*args):
        out = real(*args)
        routes.append(out[1])
        return out

    moe._router = record
    try:
        step()
    finally:
        moe._router = real
    return [int(torch.unique(r).numel()) for r in routes]


def expert_products(cfg, mlp: dict) -> None:
    """The dense form's three batched expert products of one layer at 4
    tokens, by CUDA events (the same calls as ``moe._dense_moe``): ms and
    the rate at which they read the layer's expert weights."""
    layer = {w: mlp[w][0] for w in ("w_gate", "w_up", "w_down")}
    x = torch.randn(4, cfg.d_model, device=DEV, dtype=cfg.compute_dtype)

    def products():
        h = torch.nn.functional.silu(x @ layer["w_gate"]) * (x @ layer["w_up"])
        return h @ layer["w_down"]

    for _ in range(3):
        products()
    ms = _events_ms(products, 20)
    nbytes = tensor_bytes(layer)
    print(f"one layer's expert products (3 batched products over "
          f"{cfg.moe.num_experts} experts, 4 tokens): {ms:.3f} ms (CUDA "
          f"events, 20 calls) for {nbytes / 1e9:.3f} GB of bf16 weights = "
          f"{nbytes / ms / 1e9:.3f} TB/s; x {cfg.num_layers} layers = "
          f"{ms * cfg.num_layers:.3f} ms a step")


def moe_serving() -> None:
    t_phase = time.perf_counter()
    phase("23. MoE and MLA on the card: deepseek-v2-lite-16b at full width")
    cfg = lm_configs.get_config("deepseek-v2-lite-16b")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    eng = served_through_main(cfg.name)
    peak, cap = (torch.cuda.max_memory_allocated(),
                 torch.cuda.get_device_properties(0).total_memory)
    params = eng.params
    if peak >= cap:
        raise AssertionError(f"peak memory {peak} past the card's {cap}")
    print(f"peak device memory allocated (init, engine, serving): "
          f"{(peak - base) / 1e9:.3f} GB above the {base / 1e9:.3f} GB held "
          f"before the phase; {peak / 1e9:.3f} GB of the card's "
          f"{cap / 1e9:.3f} GB in all")

    # The decode step at 4 slots against two bounds: the dense form reads
    # every expert; a routed form would read only the experts this step's
    # tokens select (counted from its routing).
    step_ms, prof, pos, step = timed_decode_step(eng)
    distinct = routed_layers(step)
    m, n_layers = cfg.moe, cfg.num_layers
    mlp = params["layers"]["mlp"]
    n_params = sum(t.numel() for t in module.leaves(params).values())
    experts = {w: mlp[w] for w in ("w_gate", "w_up", "w_down")}
    expert_params = sum(t.numel() for t in experts.values())
    expert_bytes = tensor_bytes(experts)
    cache_bytes = tensor_bytes(eng.cache)
    t_cache = eng.cache["c_kv"].shape[2]
    attn = 4 * 4 * n_layers * cfg.num_heads * t_cache * (
        cfg.mla.kv_lora + cfg.mla.qk_rope_dim)
    dense_ms, dense_by = bound(2.0 * 4 * n_params + attn,
                               tensor_bytes(params) + cache_bytes, PEAK_BF16_FLOPS)
    share = sum(distinct) / (m.num_experts * n_layers)
    routed_ms, routed_by = bound(
        2.0 * 4 * (n_params - expert_params * (1 - m.top_k / m.num_experts)) + attn,
        tensor_bytes(params) - expert_bytes * (1 - share) + cache_bytes,
        PEAK_BF16_FLOPS)
    print(f"{step_line(step_ms, prof, pos)}; bound, dense form (every expert "
          f"read): {dense_ms:.3f} ms ({dense_by}: {tensor_bytes(params) / 1e9:.3f} "
          f"GB of weights + {cache_bytes / 1e6:.1f} MB of latent cache), "
          f"{100 * dense_ms / step_ms:.1f}% of the step; bound, routed form: "
          f"{routed_ms:.3f} ms ({routed_by}: {sum(distinct) / n_layers:.1f} of "
          f"{m.num_experts} experts a layer on this step's routing, "
          f"{min(distinct)}-{max(distinct)}), {100 * routed_ms / step_ms:.1f}% "
          f"of the step")
    expert_products(cfg, mlp)
    engine_equals_greedy(cfg, params)
    del eng, params, mlp, experts, step  # the fp32 checks need the room
    torch.cuda.empty_cache()
    fp32_prefill_decode(cfg.replace(dtype="float32", num_layers=DEEPSEEK_FP32_LAYERS))
    torch.cuda.empty_cache()
    card_equals_cpu(cfg.replace(dtype="float32", num_layers=2))
    torch.cuda.empty_cache()
    qwen3_moe_two_layers()
    print(f"phase 23 wall time: {time.perf_counter() - t_phase:.1f} s")


def qwen3_moe_two_layers() -> None:
    """qwen3-moe-235b-a22b at full width and 2 layers (routed MoE, 128
    experts top-8, GQA 64 / 4 with qk-norm, no MLA), bf16, drawn in the
    compute dtypes on the card: a short served run, then its step."""
    cfg = lm_configs.get_config("qwen3-moe-235b-a22b").replace(num_layers=2)
    params = module.init_params(
        tr.param_spec(cfg), device=DEV,
        generator=torch.Generator(device=DEV).manual_seed(3),
        dtype_of=lambda path: tr.compute_dtype(path, cfg))
    eng = FiniteEngine(cfg, params, slots=4, max_len=40, device=DEV)
    for uid in range(4):
        eng.submit(Request(uid, np.random.default_rng(400 + uid).integers(
            0, cfg.vocab_size, 8).astype(np.int32), max_new_tokens=8))
    reset_launch_counts()
    finished = eng.run()
    served_tokens(eng, finished, launch_counts(), 4, 8,
                  f"ServeEngine ({cfg.name}, {cfg.num_layers} layers)")
    step_ms, prof, pos, _ = timed_decode_step(eng)
    n_params = sum(t.numel() for t in module.leaves(params).values())
    bound_ms, by = bound(2.0 * 4 * n_params,
                         tensor_bytes(params) + tensor_bytes(eng.cache),
                         PEAK_BF16_FLOPS)
    print(f"{cfg.name}, 2 layers: {step_line(step_ms, prof, pos)}; bound "
          f"{bound_ms:.3f} ms ({by}, every expert read)")


# Phase 24: the recurrent families, SSM and the Griffin hybrid, at full
# width through `launch.serve.main`; their fp32 checks at reduced depth
# after the bf16 engine is freed. At 4 layers the hybrid is one (rec, rec,
# attn) group and one ``rem`` layer; the stacked init takes the group
# count, 1, as the fan-in, so the group's weights have sd 1 and any two
# fp32 orders of its sums drift apart past JAX's tolerance from width
# 1024 up, in JAX as in the port (``tools/hybrid_fp32_gap.py``). So the
# hybrid's fp32 checks are held at 2 layers (two ``rem`` layers, fan-in
# d_model), and its 4-layer drift is measured and printed.
RECURRENT_ARCHS = {"mamba2-370m": dict(fp32_layers=4, cpu_layers=2),
                   "recurrentgemma-9b": dict(fp32_layers=2, cpu_layers=2,
                                             drift_layers=4)}
RECURRENT_TOL_RMS = 1e-3


def step_bound(cfg, params, cache, slots: int) -> tuple[float, str, str]:
    """The decode step's least time at ``slots`` rows: the weights read
    once, each slot's recurrent state read and written, the attention
    cache read once; 2 operations a weight and row, plus the state update
    and the attention over the cache. (ms, "bytes" or "operations", what
    was counted)."""
    leaves = module.leaves(cache)
    state = sum(t.numel() * t.element_size() for path, t in leaves.items()
                if path[-1] in ("h", "conv"))
    kv = sum(t.numel() * t.element_size() for path, t in leaves.items()
             if path[-1] in ("k", "v"))
    flops = 2.0 * slots * sum(t.numel() for t in module.leaves(params).values())
    flops += 4.0 * sum(t.numel() for path, t in leaves.items() if path[-1] == "h")
    for path, k in leaves.items():  # q.k and w.v over the cache, every head
        if path[-1] == "k":  # (layers, B, T, KVH, dh)
            flops += 4.0 * slots * k.shape[0] * cfg.num_heads * cfg.dh * k.shape[2]
    nbytes = tensor_bytes(params) + 2 * state + kv
    ms, by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    return ms, by, (f"{tensor_bytes(params) / 1e9:.3f} GB of weights + "
                    f"{state / 1e6:.1f} MB of recurrent state read and written"
                    + (f" + {kv / 1e6:.1f} MB of attention cache" if kv else ""))


def decode_and_forward(cfg32) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 on the card, seeded weights: the logits of a ``decode_step``
    loop over 16 tokens and of ``forward`` on them, (2, 16, V) each."""
    p32 = module.init_params(tr.param_spec(cfg32), device=DEV,
                             generator=torch.Generator(device=DEV).manual_seed(1))
    tokens = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg32.vocab_size, (2, 16)).astype(np.int32)).to(DEV)
    with torch.inference_mode():
        full, _ = tr.forward(p32, tokens, cfg32)
        cache, outs = tr.init_cache(cfg32, 2, 16, device=DEV), []
        for t in range(16):
            lg, cache = tr.decode_step(p32, cache, tokens[:, t:t + 1], t, cfg32)
            outs.append(lg[:, 0])
    return torch.stack(outs, 1), full


def fp32_decode_loop(cfg32) -> None:
    """The decode loop against ``forward`` at JAX's tolerance (rtol 2e-3,
    atol 2e-4)."""
    dec, full = decode_and_forward(cfg32)
    err = float((dec - full).abs().max())
    if not bool(torch.isfinite(full).all()) or not torch.allclose(
            dec, full, rtol=2e-3, atol=2e-4):
        raise AssertionError(f"fp32 decode loop against forward: max |diff| "
                             f"{err}, finite {bool(torch.isfinite(full).all())}")
    print(f"fp32 full width, {cfg32.num_layers} layers, the decode loop (16 "
          f"steps) against forward: max |diff| {err:.3g} (rtol 2e-3, atol 2e-4)")


def fp32_drift(cfg32) -> None:
    """Measured, held only to finite logits: the decode loop against
    ``forward`` where the reference's init leaves fp32 ill-conditioned
    (one hybrid group); the max |diff| beside the logits' RMS and the
    share of positions whose argmax agrees."""
    dec, full = decode_and_forward(cfg32)
    if not (bool(torch.isfinite(dec).all()) and bool(torch.isfinite(full).all())):
        raise AssertionError("fp32 decode loop or forward logits not finite")
    err, rms = float((dec - full).abs().max()), float(full.pow(2).mean().sqrt())
    agree = float((dec.argmax(-1) == full.argmax(-1)).float().mean())
    print(f"fp32 full width, {cfg32.num_layers} layers (one group, sd-1 group "
          f"weights), measured: the decode loop against forward max |diff| "
          f"{err:.3g} = {err / rms:.3g} of the logits' RMS {rms:.3g}, argmax "
          f"equal at {100 * agree:.1f}% of positions; logits finite")


def recurrent_model(arch: str) -> None:
    """One recurrent arch at full width: served through
    ``launch.serve.main``, its peak memory, its step against the bound,
    the ``slots=1`` engine against the loop; then (the engine freed) the
    fp32 and card-against-CPU checks at reduced depth."""
    cfg = lm_configs.get_config(arch)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    eng = served_through_main(arch)
    peak = torch.cuda.max_memory_allocated()
    print(f"{arch}: peak device memory allocated (init, engine, serving) "
          f"{(peak - base) / 1e9:.3f} GB above the {base / 1e9:.3f} GB held "
          f"before it")
    step_ms, prof, pos, _ = timed_decode_step(eng)
    bound_ms, by, what = step_bound(cfg, eng.params, eng.cache, 4)
    print(f"{step_line(step_ms, prof, pos)}; bound {bound_ms:.3f} ms ({by}: "
          f"{what}), {100 * bound_ms / step_ms:.1f}% of the step, "
          f"{100 * bound_ms / prof['busy_ms']:.1f}% of the busy time")
    engine_equals_greedy(cfg, eng.params)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    sizes = RECURRENT_ARCHS[arch]
    cfg32 = cfg.replace(dtype="float32", num_layers=sizes["fp32_layers"])
    fp32_decode_loop(cfg32)
    if cfg.family == "ssm":  # the hybrid's prefill cache is not decode-ready
        fp32_prefill_decode(cfg32)
    torch.cuda.empty_cache()
    card_equals_cpu(cfg.replace(dtype="float32", num_layers=sizes["cpu_layers"]),
                    tol=RECURRENT_TOL_RMS)
    torch.cuda.empty_cache()
    if "drift_layers" in sizes:
        fp32_drift(cfg.replace(dtype="float32", num_layers=sizes["drift_layers"]))
        torch.cuda.empty_cache()


def recurrent_serving() -> None:
    t_phase = time.perf_counter()
    phase("24. recurrent LMs on the card: mamba2-370m and recurrentgemma-9b "
          "at full width")
    for arch in RECURRENT_ARCHS:
        recurrent_model(arch)
    print(f"phase 24 wall time: {time.perf_counter() - t_phase:.1f} s")


# Phase 25: the encoder-decoder served on the card, whisper-tiny at full
# width: 4 requests of 1500 frames and a 4-token prompt, 64 greedy steps.
WHISPER = dict(requests=4, prompt=4, new=64, frames=1500)
# The stacked init takes the layer count as the fan-in, so whisper's
# attention logits spread ~100 and its softmax is one-hot: where two keys
# are within rounding, two orders of the same fp32 sums pick different
# ones, and that position's output moves by 10-30% of its RMS. At 1500
# frames the encoder is chaotic: JAX's decode_forward on frames moved by
# one ulp is a median 0.125 of the logits' RMS from itself at 4 + 4
# layers (tools/whisper_fp32_gap.py, CPU). So phase 25 holds, within one
# device, every greedy token to the teacher-forced argmax or a near-tie
# and the median position to LM_TOL_RMS (the memory is shared; the
# reference's own decode loop is a median 0.0011 from its decode_forward,
# its largest 0.109); across devices, the card's decoder on the CPU's
# memory, the same way, and prints the two encoders' gap.


def whisper_inputs(cfg, b: int, n_frames: int, seed: int):
    """Seeded frames (b, n_frames, d_model) and prompts (b, 4)."""
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((b, n_frames, cfg.d_model)).astype(np.float32)
    prompt = rng.integers(0, cfg.vocab_size, (b, WHISPER["prompt"])).astype(np.int32)
    return frames, prompt


def whisper_greedy(cfg, params, frames, prompt, n_new: int, device, feed=None,
                   memory=None):
    """``prefill_fn`` on the frames and prompts (or, given the encoder's
    ``memory``, ``decode_forward`` over it), its (self_kv, mem_kv) copied
    into a cache from ``init_cache(max_len=prompt + n_new)``, then
    ``n_new`` greedy ``decode_fn`` steps (fed ``feed``'s tokens instead of
    their own argmaxes when given). Returns (tokens (B, n_new + 1): the
    prefill's argmax and each step's, their logits, the cache)."""
    api = get_api(cfg)
    b, s = prompt.shape
    with torch.inference_mode():
        tokens = torch.from_numpy(prompt).to(device)
        if memory is None:
            logits, (self_kv, mem_kv) = api.prefill_fn(
                params, {"frames": torch.from_numpy(frames).to(device),
                         "tokens": tokens})
        else:
            logits, (self_kv, mem_kv) = encdec.decode_forward(
                params, tokens, memory.to(device), cfg, return_cache=True)
        cache = api.init_cache(b, s + n_new, enc_len=frames.shape[1], device=device)
        for name, t in zip(("k", "v", "mk", "mv"), self_kv + mem_kv):
            cache[name][:, :, :t.shape[2]] = t
        outs = [logits[:, -1].float()]
        tok = logits[:, -1].argmax(-1, keepdim=True)
        toks = [tok]
        for t in range(s, s + n_new):
            if feed is not None:
                tok = feed[:, t - s:t - s + 1].to(device)
            lg, cache = api.decode_fn(params, cache, tok, t)
            outs.append(lg[:, 0].float())
            tok = lg[:, 0].argmax(-1, keepdim=True)
            toks.append(tok)
    return torch.cat(toks, 1), torch.stack(outs, 1), cache


def near_ties(ref, toks, logits) -> int:
    """The tokens that are not ``ref``'s argmax, each required to be a
    near-tie there: its logit within twice that position's |logit diff|
    between the two passes of the best one. Returns their count."""
    want = ref.argmax(-1)
    gap = (ref.gather(-1, want[..., None]) - ref.gather(-1, toks[..., None].long()))[..., 0]
    diff = (logits - ref).abs().amax(-1)
    if bool((gap > 2 * diff).any()):
        raise AssertionError(f"tokens {toks.tolist()} against argmaxes {want.tolist()}: "
                             f"logit gaps {gap.tolist()} beyond the passes' difference")
    return int((toks != want).sum())


def fp32_drift_line(per_pos: torch.Tensor, ties: int, what: str) -> str:
    """Holds the median position's max |logit diff| (over the RMS) to
    ``LM_TOL_RMS``; returns the line that prints the drift."""
    med = float(per_pos.median())
    if not bool(torch.isfinite(per_pos).all()) or med > LM_TOL_RMS:
        raise AssertionError(f"{what}: median position's max |logit diff| {med} "
                             f"of the RMS (tolerance {LM_TOL_RMS})")
    return (f"{what}: every token the argmax or a near-tie ({ties} near-ties of "
            f"{per_pos.numel()}), the median position's max |logit diff| "
            f"{med:.3g} of the logits' RMS (tolerance {LM_TOL_RMS}); "
            f"{int((per_pos > LM_TOL_RMS).sum())} positions beyond it, the "
            f"largest {float(per_pos.max()):.3g} (attention near-ties)")


def greedy_equals_teacher(cfg, params, frames, prompt, toks, logits) -> None:
    """Each greedy token is the argmax of teacher-forced ``decode_forward``
    over the generated prefix, or a near-tie there (``near_ties``); the
    step logits against the teacher-forced ones by ``fp32_drift_line``."""
    dev = toks.device
    s = prompt.shape[1]
    with torch.inference_mode():
        memory = encdec.encode(params, torch.from_numpy(frames).to(dev), cfg)
        seq = torch.cat([torch.from_numpy(prompt).to(dev), toks[:, :-1].to(torch.int32)], 1)
        full = encdec.decode_forward(params, seq, memory, cfg)[:, s - 1:].float()
    rms = float(full.pow(2).mean().sqrt())
    per_pos = (logits - full).abs().amax(-1) / rms
    ties = near_ties(full, toks, logits)
    print(fp32_drift_line(per_pos, ties, f"{cfg.dtype} {cfg.num_layers} + "
                          f"{cfg.encdec.enc_layers} layers, greedy decode_fn against "
                          "teacher-forced decode_forward"))


def encdec_step_bound(cfg, params, cache, b: int) -> tuple[float, str, str]:
    """The decode step's least time: the decoder's and the embedding's
    weights read once, the cross attention's memory ``mk`` / ``mv`` and
    the self-attention cache read once."""
    dec = {k: params[k] for k in ("embed", "dec", "final_norm")}
    n_dec = sum(t.numel() for t in module.leaves(dec).values())
    mem = tensor_bytes({k: cache[k] for k in ("mk", "mv")})
    kv = tensor_bytes({k: cache[k] for k in ("k", "v")})
    t_all = cache["mk"].shape[2] + cache["k"].shape[2]
    flops = 2.0 * b * n_dec + 4.0 * b * cfg.num_layers * cfg.num_heads * cfg.dh * t_all
    ms, by = bound(flops, tensor_bytes(dec) + mem + kv, PEAK_BF16_FLOPS)
    return ms, by, (f"{tensor_bytes(dec) / 1e6:.1f} MB of decoder and embedding "
                    f"weights + {mem / 1e6:.1f} MB of mk/mv + {kv / 1e6:.2f} MB "
                    "of self-attention cache")


def encdec_serving() -> None:
    t_phase = time.perf_counter()
    phase("25. the encoder-decoder on the card: whisper-tiny at full width")
    cfg = lm_configs.get_config("whisper-tiny")
    api = get_api(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = module.init_params(api.param_spec(), device=DEV,
                                generator=torch.Generator(device=DEV).manual_seed(0),
                                dtype_of=lambda path: tr.compute_dtype(path, cfg))
    frames, prompt = whisper_inputs(cfg, WHISPER["requests"], WHISPER["frames"], 10)
    reset_launch_counts()
    t0 = time.perf_counter()
    toks, logits, cache = whisper_greedy(cfg, params, frames, prompt,
                                         WHISPER["new"], DEV)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_tok = toks.numel()
    if (not bool(torch.isfinite(logits).all()) or fired(counts)
            or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all())):
        raise AssertionError(f"finite logits {bool(torch.isfinite(logits).all())}, "
                             f"tokens in range, launches {fired(counts)} (none expected)")
    n_params = sum(t.numel() for t in module.leaves(params).values())
    print(f"served {WHISPER['requests']} requests of {WHISPER['frames']} frames "
          f"and {WHISPER['prompt']} prompt tokens: prefill + "
          f"{WHISPER['new']} greedy decode_fn steps, {n_tok} tokens in "
          f"{seconds:.3f} s ({n_tok / seconds:.1f} tokens/s); {n_params / 1e6:.3f} M "
          f"parameters ({tensor_bytes(params) / 1e6:.1f} MB in the compute "
          f"dtypes); every token in range, every logit finite, no kernel launched; "
          f"peak device memory allocated {(peak - base) / 1e9:.3f} GB above "
          f"{base / 1e9:.3f} GB")
    tok = toks[:, -1:].contiguous()

    def step():
        with torch.inference_mode():
            api.decode_fn(params, cache, tok, WHISPER["prompt"] + WHISPER["new"] - 1)

    step()
    step_ms = _events_ms(step, 20)
    prof = profile_call(step)
    bound_ms, by, what = encdec_step_bound(cfg, params, cache, WHISPER["requests"])
    print(f"decode step, {WHISPER['requests']} rows: {step_ms:.3f} ms (CUDA events, "
          f"20 steps); profiled: {prof['host_launches']} host launch calls, "
          f"{prof['kernels']} device kernels, device busy {prof['busy_ms']:.3f} ms "
          f"= {100 * prof['busy_ms'] / step_ms:.1f}% of the step; bound "
          f"{bound_ms:.4f} ms ({by}: {what}), {100 * bound_ms / step_ms:.2f}% of "
          "the step")
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    cfg32 = cfg.replace(dtype="float32")
    p32 = module.init_params(api.param_spec(), device=DEV,
                             generator=torch.Generator(device=DEV).manual_seed(1))
    toks, logits, _ = whisper_greedy(cfg32, p32, frames, prompt, WHISPER["new"], DEV)
    greedy_equals_teacher(cfg32, p32, frames, prompt, toks, logits)
    del p32
    torch.cuda.empty_cache()
    cfg2 = cfg32.replace(num_layers=2, encdec=dataclasses.replace(cfg.encdec,
                                                                  enc_layers=2))
    p_dev = module.init_params(encdec.encdec_param_spec(cfg2), device=DEV,
                               generator=torch.Generator(device=DEV).manual_seed(2))
    p_cpu = module.map_tree(lambda _, t: t.cpu(), p_dev)
    frames2, prompt2 = whisper_inputs(cfg2, 2, WHISPER["frames"], 11)
    with torch.inference_mode():
        mem_cpu = encdec.encode(p_cpu, torch.from_numpy(frames2), cfg2)
        mem_dev = encdec.encode(p_dev, torch.from_numpy(frames2).to(DEV), cfg2).cpu()
    rows = (mem_dev - mem_cpu).abs().amax(-1) / mem_cpu.pow(2).mean().sqrt()
    t_cpu, l_cpu, _ = whisper_greedy(cfg2, p_cpu, frames2, prompt2, 8, "cpu")
    # the card decodes the CPU's memory, fed the CPU's tokens, so that
    # neither the encoder's near-ties nor a decoder near-tie can fork it
    t_dev, l_dev, _ = whisper_greedy(cfg2, p_dev, frames2, prompt2, 8, DEV,
                                     feed=t_cpu[:, :-1], memory=mem_cpu)
    l_dev = l_dev.cpu()
    rms = float(l_cpu.pow(2).mean().sqrt())
    per_pos = (l_dev - l_cpu).abs().amax(-1) / rms
    ties = near_ties(l_cpu, t_dev.cpu(), l_dev)
    print(f"2 + 2 layers, full width, fp32, the encoder's memory on the card against "
          f"the CPU's (printed, not held: the reference's own one-ulp sensitivity, "
          f"tools/whisper_fp32_gap.py): the median row's max |diff| "
          f"{float(rows.median()):.3g} of the memory's RMS, the largest "
          f"{float(rows.max()):.3g}")
    print(fp32_drift_line(per_pos, ties, "2 + 2 layers, full width, fp32, the card's "
                          "decoder on the CPU's memory and tokens against the CPU"))
    del p_dev
    torch.cuda.empty_cache()
    print(f"phase 25 wall time: {time.perf_counter() - t_phase:.1f} s")


# Phase 26: training on the card. (a) olmo-1b through launch.train.main:
# 34 steps with a checkpoint every 15 (the newest at step 30), then a
# second main on the same directory resumes at step 30 and repeats steps
# 30-33. Each checkpoint is 16.5 GB (bf16 params, fp32 moments and
# master); the card's machine takes 45 GiB of disk writes a run, so two.
TRAIN_FLAGS = ["--arch", "olmo-1b", "--batch", "8", "--seq", "128", "--steps", "34",
               "--ckpt-every", "15", "--device", "cuda"]
RESUME_STEP = 30
# The card against the CPU: one fp32 train step at SMOKE width and 2
# layers for each family. Loss and grad norm within 1e-4 relative; the grad
# norm of the two families whose SMOKE init leaves fp32 ill-conditioned
# (tools/grad_fp64_gap.py) within 1e-2.
FAMILY_ARCHS = {"dense": "olmo-1b", "vlm": "qwen2-vl-72b",
                "moe": "deepseek-v2-lite-16b", "ssm": "mamba2-370m",
                "hybrid": "recurrentgemma-9b", "audio": "whisper-tiny"}
ILL_CONDITIONED = ("hybrid", "audio")


def timing_steps(mod, times: list):
    """Patch ``mod.make_train_step`` so that each step it returns records
    CUDA events around itself into ``times``; returns the original."""
    real = mod.make_train_step

    def make(*args, **kw):
        step = real(*args, **kw)

        def timed(*a):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = step(*a)
            e.record()
            times.append((s, e))
            return out

        return timed

    mod.make_train_step = make
    return real


def steady_ms(times: list, skip: int = 3) -> float:
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in times[skip:])


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.to(b.dtype), b) and torch.equal(
        a, b.to(a.dtype))


def trained_olmo(tmp: str) -> dict:
    """(a)'s two ``main`` runs. Returns what (a)'s later checks read."""
    times: list = []
    kept: dict = {}
    real_make = timing_steps(lm_train, times)
    real_saver, real_restore = ckpt.AsyncCheckpointer, ckpt.restore

    class Keeping(real_saver):
        def save(self, step, tree):
            if step == RESUME_STEP:  # the update is functional: never mutated
                kept["saved"] = tree
            super().save(step, tree)

    def restoring(ckpt_dir, tree_like, **kw):
        tree, step = real_restore(ckpt_dir, tree_like, **kw)
        saved = ckpt._flatten(kept.pop("saved"))
        got = ckpt._flatten(tree)
        kept["restored_equal"] = saved.keys() == got.keys() and all(
            same_bits(got[k], saved[k]) for k in saved)
        kept["restored"] = (step, len(got), sorted({f"{got[k].dtype}<-{saved[k].dtype}"
                                                    for k in got}))
        return tree, step

    ckpt.AsyncCheckpointer, ckpt.restore = Keeping, restoring
    flags = TRAIN_FLAGS + ["--ckpt-dir", tmp]
    try:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_launch_counts()
        t0 = time.perf_counter()
        losses = lm_train.main(flags)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        step_ms = steady_ms(times)
        n_steps = len(times)
        gc.collect()
        torch.cuda.empty_cache()
        resumed = lm_train.main(flags)
        counts = launch_counts()
    finally:
        lm_train.make_train_step = real_make
        ckpt.AsyncCheckpointer, ckpt.restore = real_saver, real_restore
    return dict(losses=losses, resumed=resumed, seconds=seconds, peak=peak,
                step_ms=step_ms, n_steps=n_steps, counts=counts, **kept)


def olmo_step_split(cfg) -> None:
    """One steady step's parts by CUDA events, each beside its bound, and
    the whole step profiled: the forward (no grad), the backward (the
    loss's grads without remat, less the forward), the recompute (the
    grads with ``remat="full"`` less those without) and the optimizer
    (``adamw_update``)."""
    api = get_api(cfg)
    p32 = module.init_params(api.param_spec(), device=DEV,
                             generator=torch.Generator(device=DEV).manual_seed(0))
    state = init_train_state(p32)
    params = module.map_tree(lambda _, t: t.to(torch.bfloat16), p32)
    del p32
    oc = optimizer.OptConfig(lr=3e-4, warmup_steps=3, total_steps=34)
    batch = lm_train.to_device(synth_lm_batch(DataConfig(128, 8, cfg.vocab_size), 0), DEV)
    n = sum(t.numel() for t in module.leaves(params).values())
    tokens = 8 * 128
    n_mm = n - params["embed"]["tokens"].numel()  # the lookup is no product
    attn = 4.0 * 8 * 128 * 128 * cfg.d_model * cfg.num_layers
    fwd_flops = 2.0 * tokens * n_mm + attn

    def forward():
        with torch.no_grad():
            api.loss_fn(params, batch, cfg)

    grads = value_and_grad(api.loss_fn, params, batch, cfg)[2]

    def opt_update():
        optimizer.adamw_update(grads, state, oc, params_dtype=torch.bfloat16)

    step = make_train_step(cfg, oc, loss_fn=api.loss_fn)
    parts = {"forward": forward,
             "grads, no remat": lambda: value_and_grad(api.loss_fn, params, batch,
                                                       cfg.replace(remat="none")),
             "grads, remat full": lambda: value_and_grad(api.loss_fn, params, batch, cfg),
             "optimizer": opt_update,
             "step": lambda: step(params, state, batch)}
    ms = {}
    for name, fn in parts.items():
        fn()
        ms[name] = _events_ms(fn, 3)
    bounds = {"forward": bound(fwd_flops, 2.0 * n, PEAK_BF16_FLOPS),
              "backward": bound(2 * fwd_flops, 4.0 * n, PEAK_BF16_FLOPS),
              "recompute": bound(fwd_flops - 2.0 * tokens * cfg.d_model * cfg.vocab_size,
                                 2.0 * n, PEAK_BF16_FLOPS),
              "optimizer": bound(12.0 * n, 28.0 * n, PEAK_FP32_FLOPS)}
    split = {"forward": ms["forward"],
             "backward": ms["grads, no remat"] - ms["forward"],
             "recompute": ms["grads, remat full"] - ms["grads, no remat"],
             "optimizer": ms["optimizer"]}
    total_bound = sum(b for b, _ in bounds.values())
    for name, part in split.items():
        b_ms, by = bounds[name]
        print(f"  {name:9s} {part:8.3f} ms (CUDA events, 3 calls) against a bound of "
              f"{b_ms:.3f} ms ({by})")
    prof = profile_call(parts["step"])
    print(f"olmo-1b train step at 8 x 128 tokens: {ms['step']:.3f} ms (CUDA events, 3 "
          f"steps), parts sum {sum(split.values()):.3f} ms, bound {total_bound:.3f} ms "
          f"({100 * total_bound / ms['step']:.1f}% of the step); profiled: "
          f"{prof['host_launches']} host launch calls, {prof['kernels']} device "
          f"kernels, device busy {prof['busy_ms']:.3f} ms = "
          f"{100 * prof['busy_ms'] / prof['wall_ms']:.1f}% of the profiled step's "
          f"{prof['wall_ms']:.3f} ms")


def olmo_training() -> None:
    cfg = lm_configs.get_config("olmo-1b")
    with tempfile.TemporaryDirectory() as tmp:
        free = shutil.disk_usage(tmp).free
        run = trained_olmo(tmp)
    losses, resumed = run["losses"], run["resumed"]
    k = max(len(losses) // 5, 1)
    first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
    if not (np.isfinite(losses).all() and last < first) or fired(run["counts"]):
        raise AssertionError(f"losses {losses}, launches {fired(run['counts'])}")
    print(f"olmo-1b, full width (16 layers, d_model 2048, vocab 50304, remat full, "
          f"bf16 params, fp32 master), launch.train.main {' '.join(TRAIN_FLAGS)}: "
          f"{run['n_steps']} steps in {run['seconds']:.1f} s (checkpoints every 15 "
          f"on a disk with {free / 1e9:.1f} GB free), every loss finite, first-fifth "
          f"mean {first:.4f} -> last-fifth mean {last:.4f}; steady step "
          f"{run['step_ms']:.3f} ms (median by CUDA events after 3 steps); peak "
          f"device memory allocated {run['peak'] / 1e9:.3f} GB; no kernel launched")
    step, n_leaves, casts = run["restored"]
    if not run["restored_equal"] or step != RESUME_STEP:
        raise AssertionError(f"restored step {step}: tree bit for bit the saved "
                             f"one: {run['restored_equal']}")
    print(f"resumed from step {step}: all {n_leaves} leaves (params and OptState) "
          f"equal the saved ones bit for bit (restored <- saved dtypes: {casts})")
    straight = losses[RESUME_STEP:]
    if len(resumed) != len(straight) or not np.allclose(resumed, straight, rtol=1e-3):
        raise AssertionError(f"resumed losses {resumed} against {straight}")
    bitwise = [a == b for a, b in zip(resumed, straight)]
    print(f"resumed steps {RESUME_STEP}-{RESUME_STEP + len(resumed) - 1}: losses "
          f"{[round(x, 6) for x in resumed]} against the straight run's "
          f"{[round(x, 6) for x in straight]}, within 1e-3 relative (max "
          f"{max(abs(a - b) / abs(b) for a, b in zip(resumed, straight)):.3g}); bit "
          f"for bit: {bitwise}")
    gc.collect()
    torch.cuda.empty_cache()
    olmo_step_split(cfg)
    gc.collect()
    torch.cuda.empty_cache()


def one_full_step(arch: str, batch: dict) -> None:
    """One train step at full width (fp32 seeded init, bf16 params after
    the step): the loss and grad norm finite, the norm > 0, the params
    changed."""
    cfg = lm_configs.get_config(arch)
    api = get_api(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = module.init_params(api.param_spec(), device=DEV,
                                generator=torch.Generator(device=DEV).manual_seed(0))
    n = sum(t.numel() for t in module.leaves(params).values())
    step = make_train_step(cfg, optimizer.OptConfig(lr=1e-3, warmup_steps=1,
                                                    total_steps=10), loss_fn=api.loss_fn)
    first = next(iter(module.leaves(params).values())).clone()
    t0 = time.perf_counter()
    new, _, m = step(params, init_train_state(params), batch)
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    seconds = time.perf_counter() - t0
    moved = not torch.equal(next(iter(module.leaves(new).values())).float(), first)
    if not (np.isfinite(loss) and np.isfinite(gnorm) and gnorm > 0 and moved):
        raise AssertionError(f"{arch}: loss {loss}, grad norm {gnorm}, params moved {moved}")
    print(f"{arch} at full width ({n / 1e9:.3f} B parameters, remat {cfg.remat}), one "
          f"train step on {' x '.join(str(x) for x in batch['tokens'].shape)} tokens"
          + (f" and {tuple(batch['frames'].shape)} frames" if "frames" in batch else "")
          + f": loss {loss:.4f}, grad norm {gnorm:.4f}, params changed; first step "
          f"{seconds:.2f} s (host clock, allocation included), peak device memory "
          f"allocated {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    del params, new
    gc.collect()
    torch.cuda.empty_cache()


def family_batch(cfg, b: int = 2, s: int = 16) -> dict:
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
             "mask": np.ones((b, s), np.float32)}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    if cfg.mrope_sections:
        pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
        batch["positions"] = np.ascontiguousarray(np.broadcast_to(pos, (3, b, s)))
    return batch


def families_card_equals_cpu() -> None:
    oc = optimizer.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    for family, arch in FAMILY_ARCHS.items():
        cfg = lm_configs.get_smoke(arch).replace(dtype="float32", num_layers=2)
        api = get_api(cfg)
        p_cpu = module.init_params(api.param_spec(), device="cpu",
                                   generator=torch.Generator().manual_seed(0))
        batch = family_batch(cfg)
        out = {}
        for dev in ("cpu", DEV):
            params = module.map_tree(lambda _, t: t.to(dev), p_cpu)
            step = make_train_step(cfg, oc, loss_fn=api.loss_fn,
                                   param_dtype=torch.float32)
            _, _, m = step(params, init_train_state(params), lm_train.to_device(batch, dev))
            out[str(dev)] = (float(m["loss"]), float(m["grad_norm"]))
        (l_cpu, g_cpu), (l_dev, g_dev) = out["cpu"], out[str(DEV)]
        tol = 1e-2 if family in ILL_CONDITIONED else 1e-4
        if abs(l_dev - l_cpu) > 1e-4 * abs(l_cpu) or abs(g_dev - g_cpu) > tol * g_cpu:
            raise AssertionError(f"{family} ({arch}): card loss {l_dev}, grad norm "
                                 f"{g_dev}; CPU {l_cpu}, {g_cpu}")
        print(f"  {family:6s} {arch:21s} card = CPU: loss {l_dev:.6f} (rel "
              f"{abs(l_dev - l_cpu) / abs(l_cpu):.2g}), grad norm {g_dev:.6f} (rel "
              f"{abs(g_dev - g_cpu) / g_cpu:.2g}, tolerance {tol})")


def vig_training() -> None:
    times: list = []
    real_make = timing_steps(train_vig, times)
    flags = ["--full", "--num-classes", "1000", "--steps", "30", "--batch", "8",
             "--device", "cuda"]
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = train_vig.main(flags)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        step_ms = steady_ms(times)
    finally:
        train_vig.make_train_step = real_make
    losses = out["losses"]
    k = max(len(losses) // 5, 1)
    first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
    if not (np.isfinite(losses).all() and last < first) or fired(counts):
        raise AssertionError(f"ViG losses {losses}, launches {fired(counts)}")
    print(f"vig_ti_iso at full width (224^2, D = 192, 12 blocks, 1000 classes, B = 8, "
          f"blocked) through launch.train_vig.main {' '.join(flags)}: {len(losses)} "
          f"steps in {seconds:.1f} s, every loss finite, first-fifth mean {first:.4f} "
          f"-> last-fifth mean {last:.4f}; steady step {step_ms:.3f} ms (median by "
          f"CUDA events after 3 steps); peak device memory allocated "
          f"{peak / 1e9:.3f} GB; no kernel launched")
    try:
        train_vig.main(["--full", "--num-classes", "1000", "--steps", "1", "--batch",
                        "8", "--digc-impl", "cuda", "--device", "cuda"])
    except NotImplementedError as e:
        if "item 20" not in str(e):
            raise
        print(f"--digc-impl cuda fails at its first step: {e}")
    else:
        raise AssertionError("--digc-impl cuda trained: the MRConv kernel has no backward")
    serve_trained(out["cfg"], out["params"])


def serve_trained(cfg, params) -> None:
    """The trained weights served through both kernels on phase 4's trace,
    each request bit for bit the eager ``cuda`` forward of its bucket batch;
    each layer's neighbour lists against the ``blocked`` tier's on the
    recorded features."""
    images = [testing.images(uid, 1, cfg.image_size)[0] for uid in range(20)]
    eng = VigServeEngine(cfg, params, digc_impl="cuda", device=DEV)
    serve_trace(eng, images)  # warm-up: first use of each bucket
    reset_launch_counts()
    batches: list = []
    reqs, _, _ = serve_trace(eng, images, batches)
    counts = launch_counts()
    assert_no_faults(eng, "serving the trained vig_ti_iso")
    want = sum(cfg.depths) * len(trace_ticks())  # one launch each a block
    if counts["digc_topk"] != want or counts["mrconv"] != want:
        raise AssertionError(f"launches {fired(counts)}, expected {want} of each")
    check_bucket_forwards(params, cfg, "cuda", batches)
    batch = to_dev(np.stack(images[:8]))
    capture: list = []
    with torch.inference_mode():
        out = vig.vig_forward(params, batch, cfg, digc_impl="cuda",
                              digc_capture=capture)
        ref = vig.vig_forward(params, batch, cfg, digc_impl="blocked")
        geo = [(d, k) for p in vig.vig_stage_plans(cfg, "cuda")
               for d, k in zip(p.dilations, p.k_effs)]
        equal_rows, rows, swaps = 0, 0, []
        for (_, h, cond), (dil, k) in zip(capture, geo):
            y = h if cond is None else cond
            dist, idx = digc_topk_cuda(h, y, k * dil)
            dist, idx = dist[..., ::dil], idx[..., ::dil]
            b_idx, b_dist = digc_blocked(h, y, k=k, dilation=dil, return_dists=True)
            scale = float(h.square().sum(-1).max() + y.square().sum(-1).max())
            testing.assert_topk_match(idx.cpu().numpy(), dist.cpu().numpy(),
                                      b_idx.cpu().numpy(), b_dist.cpu().numpy(),
                                      rtol=RTOL, atol=ATOL + RTOL * scale)
            equal_rows += int((idx == b_idx).all(-1).sum())
            rows += idx.shape[0] * idx.shape[1]
            swaps.append(int((idx != b_idx).sum()))
    gap = float((out - ref).abs().max())
    print(f"served the trained weights through VigServeEngine(digc_impl='cuda'): "
          f"{len(reqs)} requests, {fired(counts)} launches over "
          f"{len(trace_ticks())} ticks, every request's logits bit for bit the eager "
          f"cuda forward of its bucket batch; per layer the kernel's neighbour lists "
          f"equal the blocked tier's except at fp32 near-ties: {equal_rows} of "
          f"{rows} lists equal ({100 * equal_rows / rows:.2f}%), near-tie swaps per "
          f"layer {swaps}; logits against the blocked forward: max |diff| {gap:.3g} "
          f"(largest logit {float(ref.abs().max()):.3g}; not held to a bound)")


def training() -> None:
    t_phase = time.perf_counter()
    phase("26. training on the card: olmo-1b, whisper-tiny, mamba2-370m and "
          "vig_ti_iso at full width")
    olmo_training()
    cfg_w = lm_configs.get_config("whisper-tiny")
    frames, _ = whisper_inputs(cfg_w, 8, WHISPER["frames"], 12)
    rng = np.random.default_rng(12)
    one_full_step("whisper-tiny", {
        "frames": to_dev(frames),
        "tokens": to_dev(rng.integers(0, cfg_w.vocab_size, (8, 128)).astype(np.int32)),
        "labels": to_dev(rng.integers(0, cfg_w.vocab_size, (8, 128)).astype(np.int32)),
        "mask": torch.ones(8, 128, device=DEV)})
    cfg_m = lm_configs.get_config("mamba2-370m")
    one_full_step("mamba2-370m", lm_train.to_device(
        synth_lm_batch(DataConfig(128, 8, cfg_m.vocab_size), 0), DEV))
    print("one fp32 train step at SMOKE width and 2 layers, card against CPU:")
    families_card_equals_cpu()
    vig_training()
    print(f"phase 26 wall time: {time.perf_counter() - t_phase:.1f} s")


def main() -> None:
    name, smi = card_and_software()
    build()
    calibrate_sleep()
    err_digc = kernels_vs_plain()
    phase4_counts, per_request, rps_exact = serving()
    launches = phase4_counts["digc_topk"]
    pyramid()
    rows = timings(per_request)
    err_variants = variants_vs_plain()
    served_counts, pos_counts = serving_variants()
    pyramid_blocked()
    knn_counts = knn_attention_phase()
    err_legacy = legacy_vs_plain()
    tuning_counts, bucket_counts, _ = tuned_serving(rps_exact)
    pyramid_tuned()
    stateful_serving(phase4_counts, rps_exact)
    specs = stale_graph_serving()
    parking(specs["tick"])
    faults_on_card(specs["tick"])
    captured_vs_eager(specs)
    lattice_per_n = lattice_serving()
    scheduler_phase()
    approx_serving()
    lm_serving()
    moe_serving()
    recurrent_serving()
    encdec_serving()
    training()
    # The summary row of each kernel is at the serving shape: vig_ti_iso
    # at B = 8 (N = M = 196, D = 192), with its middle kd for DIGC; the
    # causal variant's at the KNN attention shape. Launches are those of
    # the path that runs each: serving (phase 4; packed and bf16, phase 8),
    # the public digc() with a bias (phase 8), KNN attention (phase 10),
    # tuning (legacy, phase 12) and serving through bucket_rounds (phase 12).
    digc_shapes, mr = (sorted(s) for s in main_path_shapes("vig_ti_iso"))
    iso = [8, *digc_shapes[len(digc_shapes) // 2]]
    knn = [KNN["heads"], KNN["seq"], KNN["seq"], KNN["dh"], KNN["nn"]]
    pick = {"digc_topk": iso, "digc_topk.packed": iso, "digc_topk.mxu_bf16": iso,
            "digc_topk.pos_bias": iso, "digc_topk.causal": knn,
            "digc_topk.legacy": iso, "digc_topk.bucket_rounds": iso,
            "mrconv": [8, *mr[0]]}
    counts = {"digc_topk": launches, "mrconv": launches,
              "digc_topk.packed": served_counts["digc_topk.packed"],
              "digc_topk.mxu_bf16": served_counts["digc_topk.mxu_bf16"],
              "digc_topk.pos_bias": pos_counts["digc_topk.pos_bias"],
              "digc_topk.causal": knn_counts["digc_topk.causal"],
              "digc_topk.legacy": tuning_counts["digc_topk.legacy"],
              "digc_topk.bucket_rounds": bucket_counts["digc_topk.bucket_rounds"]}
    errs = {"digc_topk": err_digc, "mrconv": 0.0,  # MRConv: bitwise checked
            **{f"digc_topk.{v}": e for v, e in err_variants.items()},
            **{f"digc_topk.{v}": e for v, e in err_legacy.items()}}
    summary = []
    for kname, meta in KERNELS.items():
        row = next(r for r in rows[kname] if r["shape"] == pick[kname])
        summary.append({"name": kname, **meta, "launches": counts[kname],
                        "max_abs_err": errs[kname], "ms": row["ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"], "shape": row["shape"]})
        if kname in ("digc_topk", "mrconv"):
            # phase 19's timed pass over the lattice, by node count N
            summary[-1]["lattice_launches"] = lattice_per_n
    print(smi)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
