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
   profile one serving tick (device busy share, time by operator).

The line before the last is the kernel summary as JSON; the last line is
``{"ok": true, "device": {...}}``. Without a card it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import testing  # noqa: E402
from repro_torch.kernels import _build, launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.digc_topk import digc_topk_cuda, digc_topk_plain  # noqa: E402
from repro_torch.kernels.mrconv import mrconv_cuda, mrconv_plain  # noqa: E402
from repro_torch.models import convert, vig  # noqa: E402
from repro_torch.serve.engine import VigRequest, VigServeEngine  # noqa: E402

# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, HBM3 rate.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# Distances are fp32 sums taken in two orders (the kernel's FMA chain vs
# cuBLAS), and (|x|^2 - 2 x.y) + |y|^2 cancels: the rounding scales with
# the squared norms, not with the distance. Tolerance: ATOL + RTOL * (the
# largest |x|^2 + the largest |y|^2) absolute, RTOL relative.
RTOL, ATOL = 1e-5, 1e-4
DEV = torch.device("cuda", 0)
SLEEP_CYCLES_PER_MS = 1.0e6  # set by calibrate_sleep()

KERNELS = {
    "digc_topk": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/digc_topk.cu",
        "replaces": "src/repro/kernels/digc_topk.py:394",
    },
    "mrconv": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mrconv.cu",
        "replaces": "src/repro/kernels/mrconv.py:82",
    },
}


def phase(title: str) -> None:
    print(f"\n=== {title}", flush=True)


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


def check_digc(x, y, kd: int) -> tuple[float, int]:
    """Kernel vs plain on one input; returns the largest distance error
    and the number of near-tie swaps (entries whose indices differ)."""
    dist, idx = digc_topk_cuda(x, y, kd)
    ref_d, ref_i = digc_topk_plain(x, y, kd)
    norms = float(x.square().sum(-1).max() + y.square().sum(-1).max())
    torch.cuda.synchronize()
    testing.assert_topk_match(idx.cpu().numpy(), dist.cpu().numpy(),
                              ref_i.cpu().numpy(), ref_d.cpu().numpy(),
                              rtol=RTOL, atol=ATOL + RTOL * norms)
    return float((dist - ref_d).abs().max()), int((idx != ref_i).sum())


def check_mrconv(x, y, idx) -> None:
    out = mrconv_cuda(x, y, idx)
    ref = mrconv_plain(x, y, idx)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise AssertionError(
            f"mrconv differs from its plain version by "
            f"{float((out - ref).abs().max())} at {tuple(x.shape)}, k={idx.shape[-1]}")


def check_layers(capture: list, plans) -> None:
    """Each captured DIGC call's kernels against the plain versions on the
    features the model fed them."""
    geo = [(d, k) for p in plans for d, k in zip(p.dilations, p.k_effs)]
    if len(capture) != len(geo):
        raise AssertionError(f"{len(capture)} DIGC calls for {len(geo)} blocks")
    worst, swaps = 0.0, []
    for (key, h, cond), (dil, k) in zip(capture, geo):
        y = h if cond is None else cond
        kd = k * dil
        err, n_swaps = check_digc(h, y, kd)
        worst = max(worst, err)
        swaps.append(n_swaps)
        idx = digc_topk_cuda(h, y, kd)[1][..., ::dil].contiguous()
        check_mrconv(h, y, idx)
    print(f"{len(geo)} layers: kernels equal their plain versions on the "
          f"captured features (max |dist err| {worst:.3g}; near-tie swaps "
          f"per layer {swaps})")


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


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
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


def serving() -> tuple[int, dict]:
    phase("4. serving vig_ti_iso at full width")
    cfg = vig.VIG_VARIANTS["vig_ti_iso"]
    params = convert.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                 device=DEV)
    images = [testing.images(uid, 1, cfg.image_size)[0] for uid in range(20)]
    eng = VigServeEngine(cfg, params, digc_impl="cuda", device=DEV)
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
    if counts != {"digc_topk": want, "mrconv": want}:
        raise AssertionError(f"launches {counts}, expected {want} of each")
    logits = np.stack([r.logits for r in reqs])
    if logits.shape != (20, 1000) or not np.isfinite(logits).all():
        raise AssertionError(f"logits {logits.shape} not finite")
    print(f"launches in the timed pass: {counts} over {ticks} ticks, "
          f"{len(reqs)} requests")
    print(f"requests/s: {len(reqs) / seconds:.2f} ({seconds * 1e3:.1f} ms for "
          f"{len(reqs)} requests)")
    for b in sorted(lat):
        print(f"bucket {b}: median tick {statistics.median(lat[b]):.2f} ms "
              f"over {len(lat[b])} ticks")
    # Per-layer kernel checks and the logits against the plain reference
    # tier, on the first tick's eight images.
    batch = torch.from_numpy(np.stack(images[:8])).to(DEV)
    capture: list = []
    with torch.inference_mode():
        out = vig.vig_forward(params, batch, cfg, digc_impl="cuda",
                              digc_capture=capture)
        ref = vig.vig_forward(params, batch, cfg, digc_impl="reference")
    check_layers(capture, vig.vig_stage_plans(cfg, "cuda"))
    check_logits(out, ref, logits[:8])
    profile_tick(eng, images)
    return want, {k: v / len(reqs) for k, v in counts.items()}


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
    if counts != {"digc_topk": blocks, "mrconv": blocks}:
        raise AssertionError(f"launches {counts}, expected {blocks} of each")
    print(f"launches: {counts}; stage (N, M): "
          f"{[(p.n, p.m) for p in plans]}")
    with torch.inference_mode():
        ref = vig.vig_forward(params, batch, cfg, digc_impl="reference")
    check_logits(out, ref)
    check_layers(capture, plans)
    small_forwards()


def timings(per_request: dict) -> dict:
    phase("6. times at the main-path shapes (B = 8), CUDA events")
    calibrate_sleep()
    rows: dict[str, list] = {"digc_topk": [], "mrconv": []}
    b = 8
    digc, mr = main_path_shapes("vig_ti_iso", "vig_ti_pyr")
    for n, m, d, kd in sorted(digc):
        x = to_dev(testing.features(1, b, n, d))
        y = to_dev(testing.features(2, b, m, d))
        ms, call = time_ms(lambda: digc_topk_cuda(x, y, kd))
        plain, _ = time_ms(lambda: digc_topk_plain(x, y, kd))
        lib, _ = time_ms(lambda: torch.topk(torch.cdist(x, y), kd, dim=-1,
                                            largest=False))
        bms, by = bound(2.0 * b * n * m * d, 4.0 * b * (n + m) * d + 8.0 * b * n * kd)
        rows["digc_topk"].append(dict(shape=[b, n, m, d, kd], ms=ms, call_ms=call,
                                      plain_ms=plain, library_ms=lib,
                                      bound_ms=bms, bound_by=by))
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
              "mrconv": "index_select + subtract + amax (three calls)"}
    for name, rs in rows.items():
        print(f"{name}: launches per served request {per_request[name]:.2f}; "
              f"library = {labels[name]}")
        for r in rs:
            print(f"  {name} {r['shape']}: kernel {r['ms']:.4f} ms (per call "
                  f"from Python {r['call_ms']:.4f} ms), bound {r['bound_ms']:.4f} "
                  f"ms ({r['bound_by']}), plain {r['plain_ms']:.4f} ms, library "
                  f"{r['library_ms']:.4f} ms")
    return rows


def main() -> None:
    name, smi = card_and_software()
    build()
    err_digc = kernels_vs_plain()
    launches, per_request = serving()
    pyramid()
    rows = timings(per_request)
    # The summary row of each kernel is at the serving shape: vig_ti_iso
    # at B = 8 (N = M = 196, D = 192), with its middle kd for DIGC.
    digc, mr = (sorted(s) for s in main_path_shapes("vig_ti_iso"))
    pick = {"digc_topk": [8, *digc[len(digc) // 2]], "mrconv": [8, *mr[0]]}
    errs = {"digc_topk": err_digc, "mrconv": 0.0}  # MRConv: bitwise checked
    summary = []
    for kname, meta in KERNELS.items():
        row = next(r for r in rows[kname] if r["shape"] == pick[kname])
        summary.append({"name": kname, **meta, "launches": launches,
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
