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
   a ragged multi-tenant trace that uses buckets 1, 2, 4 and 8; check the
   launch counts and each layer's kernel output on the captured features;
5. one batched ``vig_ti_pyr`` forward at 224^2 with the same checks,
   then both models, narrowed, against the reference tier end to end;
6. time each kernel with CUDA events beside its bound, its plain version
   and the PyTorch library calls that compute the same function, and
   profile one serving tick (device busy share, time by operator); the
   DIGC kernel's variants are timed at the same shapes;
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
    reference tier.

Each path of phases 4, 5, 8, 10 and 12 runs with the launch counts set
to 0 just before it and read just after; a kernel or variant of that path
with no launch fails the run. The line before the last is the kernel summary
as JSON (one entry per kernel and DIGC variant); the last line is
``{"ok": true, "device": {...}}``. Without a card it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
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
from repro_torch.core import perfmodel  # noqa: E402
from repro_torch.core.tuner import LEGACY_TILES, time_calls  # noqa: E402
from repro_torch.core.knn_attention import knn_attention_mha  # noqa: E402
from repro_torch.core.packedkey import idx_bits_for  # noqa: E402
from repro_torch.kernels import _build, launch_counts, ops, reset_launch_counts  # noqa: E402
from repro_torch.kernels.digc_topk import BIG, digc_topk_cuda, digc_topk_plain  # noqa: E402
from repro_torch.kernels.mrconv import mrconv_cuda, mrconv_plain  # noqa: E402
from repro_torch.models import convert, vig  # noqa: E402
from repro_torch.serve.engine import VigRequest, VigServeEngine  # noqa: E402

# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, dense bf16 on
# the tensor cores, HBM3 rate.
PEAK_FP32_FLOPS = 67e12
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


def serve_trace(eng, images) -> tuple[list, dict, float]:
    lat: dict[int, list] = {}
    reqs = []
    t0 = time.perf_counter()
    for tick in trace_ticks():
        for uid, tenant in tick:
            req = VigRequest(uid, images[uid], tenant=tenant)
            eng.submit(req)
            reqs.append(req)
        s = time.perf_counter()
        eng.step()  # returns after the logits reach the host
        lat.setdefault(eng.last_bucket, []).append((time.perf_counter() - s) * 1e3)
    return reqs, lat, time.perf_counter() - t0


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
    reqs, lat, seconds = serve_trace(eng, images)
    counts = launch_counts()
    stats = eng.stats()
    print(f"stats: {json.dumps(stats)}")
    if stats["compile_count"] > 4:
        raise AssertionError(f"{stats['compile_count']} programs for 4 buckets")
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


def serving() -> tuple[int, dict, float]:
    eng, images, counts, served, _, _, rps = serve_iso(
        "4. serving vig_ti_iso at full width", "cuda", {})
    profile_tick(eng, images)
    return (counts["digc_topk"], {k: v / served for k, v in counts.items()},
            rps)


def profile_tick(eng, images) -> None:
    """One bucket-8 tick of eight new tenants under torch.profiler: the
    device's busy share of the tick and the operators that take the
    device's and the host's time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for uid in range(8):
            eng.submit(VigRequest(100 + uid, images[uid], tenant=f"p{uid}"))
        eng.step()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0)

    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    print(f"profiled tick (bucket {eng.last_bucket}): {wall_ms:.2f} ms on the "
          f"host clock under the profiler, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%)")
    for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
        print(f"  device {dev_us(e) / 1e3:8.3f} ms x{e.count:<4d} {e.key[:70]}")
    cpu = [e for e in events if not str(e.device_type).endswith("CUDA")]
    for e in sorted(cpu, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]:
        print(f"  host   {e.self_cpu_time_total / 1e3:8.3f} ms x{e.count:<4d} "
              f"{e.key[:70]}")


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
    the causal triangle), at the fp32 rate or, for bf16 operands, the
    tensor cores' bf16 rate."""
    ms, call = time_ms(fn)
    plain_ms, _ = time_ms(plain)
    lib = time_ms(library)[0] if library is not None else None
    pairs = n * m if pairs is None else pairs
    nbytes = 4.0 * b * (n + m) * d + 8.0 * b * n * kd + (4.0 * n * m if pos else 0)
    bms, by = bound(2.0 * b * pairs * d, nbytes,
                    PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS)
    return dict(shape=[b, n, m, d, kd], ms=ms, call_ms=call, plain_ms=plain_ms,
                library_ms=lib, bound_ms=bms, bound_by=by)


def timings(per_request: dict) -> dict:
    phase("6. times at the main-path shapes (B = 8), CUDA events")
    calibrate_sleep()
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
        for vname, kw in variants.items():
            rows.setdefault(f"digc_topk.{vname}", []).append(digc_row(
                b, n, m, d, kd, lambda: digc_topk_cuda(x, y, kd, **kw),
                lambda: digc_topk_plain(x, y, kd, **kw),
                pos="pos_bias" in kw, bf16=kw.get("mxu_bf16", False),
                library=(lambda: torch.topk(torch.cdist(x, y), kd, dim=-1,
                                            largest=False))
                if vname == "legacy" else None))
    # The KNN attention shape: heads as the batch, causal and not.
    q, k, _ = (t.transpose(0, 1).contiguous() for t in knn_inputs())
    h, seq, dh, nn = KNN["heads"], KNN["seq"], KNN["dh"], KNN["nn"]
    for vname, causal in (("digc_topk", False), ("digc_topk.causal", True)):
        rows.setdefault(vname, []).append(digc_row(
            h, seq, seq, dh, nn,
            lambda: digc_topk_cuda(q, k, nn, causal=causal),
            lambda: digc_topk_plain(q, k, nn, causal=causal),
            pairs=seq * (seq + 1) // 2 if causal else None))
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
              "mrconv": "index_select + subtract + amax (three calls)"}
    for name, rs in rows.items():
        if name in ("digc_topk", "mrconv"):
            print(f"{name}: launches per served request {per_request[name]:.2f}; "
                  f"library = {labels[name]}")
        else:  # launches: phases 8, 10 and 12
            print(f"{name}: library = "
                  f"{labels.get(name, 'none (no single PyTorch call)')}")
        for r in rs:
            lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
            print(f"  {name} {r['shape']}: kernel {r['ms']:.4f} ms (per call "
                  f"from Python {r['call_ms']:.4f} ms), bound {r['bound_ms']:.4f} "
                  f"ms ({r['bound_by']}), plain {r['plain_ms']:.4f} ms, library "
                  f"{lib}")
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
                    kernel_merge=r.config.kernel_merge, backend="cuda",
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


def main() -> None:
    name, smi = card_and_software()
    build()
    err_digc = kernels_vs_plain()
    launches, per_request, rps_exact = serving()
    pyramid()
    rows = timings(per_request)
    err_variants = variants_vs_plain()
    served_counts, pos_counts = serving_variants()
    pyramid_blocked()
    knn_counts = knn_attention_phase()
    err_legacy = legacy_vs_plain()
    tuning_counts, bucket_counts, _ = tuned_serving(rps_exact)
    pyramid_tuned()
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
    print(smi)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
