"""Trace replay through the SLO-bounded admission scheduler (the twin of
``examples/serve_trace.py``).

Replays the seeded Poisson + burst arrival trace through a
``VigServeEngine`` under a ``VirtualClock``, twice:

* the exact-size baseline (``buckets=None``, ``slo_ms=0``): every arrival
  wave dispatches at once at its own batch size;
* the scheduled engine (bucketed, ``slo_ms``): sub-width arrivals wait up
  to their SLO and coalesce into fuller ticks; then the served trace
  re-tunes the bucket set from its arrival histogram.

Prints each engine's tick, utilization and program counts and the tuned
bucket set. The virtual clock jumps straight to deadlines: no sleep.

    PYTHONPATH=src python -m repro_torch.examples.serve_trace
    PYTHONPATH=src python -m repro_torch.examples.serve_trace --slo-ms 80 --seed 3
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import vig
from repro_torch.models.convert import init_params
from repro_torch.serve.engine import VigServeEngine
from repro_torch.serve.sched import VirtualClock, arrival_trace, replay


def _model(image_size, patch, device):
    cfg = vig.VIG_VARIANTS["vig_ti_iso"].replace(
        image_size=image_size, patch=patch, embed_dims=(32,), depths=(2,),
        num_classes=10, k=4, digc_impl="blocked",
    )
    params = init_params(cfg, generator=torch.Generator(device=device).manual_seed(0),
                         device=device)
    return cfg, params


def _report(tag, eng, ticks):
    s = eng.stats()
    served = sum(t[0] for t in ticks)
    print(f"{tag}:")
    print(f"  requests {served}  ticks {len(ticks)}  "
          f"deferrals {s['deferrals']}")
    print(f"  live lanes {s['live_lanes']}  padded {s['padded_lanes']}  "
          f"util {s['util']:.3f}")
    print(f"  compiled programs {s['compile_count']}  "
          f"buckets {s['buckets']}")
    print(f"  prefetch issued/hits {s['prefetch_issued']}"
          f"/{s['prefetch_hits']}  park hits {s['park_hits']}")


def main(argv=None) -> tuple:
    ap = argparse.ArgumentParser()
    ap.add_argument("--image-size", type=int, default=32)
    ap.add_argument("--patch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tenants", type=int, default=8)
    ap.add_argument("--arrivals", type=int, default=48)
    ap.add_argument("--slo-ms", type=float, default=120.0)
    ap.add_argument("--bucket-cap", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg, params = _model(args.image_size, args.patch, dev)
    rng = np.random.default_rng(args.seed)
    images = {f"t{i}": rng.standard_normal(
        (args.image_size, args.image_size, 3)).astype(np.float32)
        for i in range(args.tenants)}
    arrivals = arrival_trace(seed=args.seed, tenants=args.tenants,
                             poisson_n=args.arrivals)
    print(f"trace: {len(arrivals)} arrivals over "
          f"{arrivals[-1].t_ms:.0f} ms, {args.tenants} tenants")

    clock = VirtualClock()
    exact = VigServeEngine(cfg, params, digc_impl="blocked", autotune=False,
                           buckets=None, clock=clock, device=dev)
    _report("exact-size baseline (slo_ms=0)",
            exact, replay(exact, arrivals, images, clock=clock))

    clock = VirtualClock()
    sched = VigServeEngine(cfg, params, digc_impl="blocked", autotune=False,
                           slo_ms=args.slo_ms, clock=clock,
                           bucket_cap=args.bucket_cap, device=dev)
    _report(f"scheduled (slo_ms={args.slo_ms:g}, buckets={sched.buckets})",
            sched, replay(sched, arrivals, images, clock=clock))
    tuned = sched.retune_buckets()
    print(f"  retuned bucket set for this trace: {tuned}")
    return exact, sched, tuned


if __name__ == "__main__":
    main()
