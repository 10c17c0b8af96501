"""The knee of an open-loop cell: its traffic offered at several fixed
rates, one process, one set-up.

    python vigbench/sweep.py --workload <cell> --rates 1000,1500,2000 --seconds 10

For each rate it prints the served rate, the latency p50 and p95 (ms),
and the queue: its mean depth before a tick in the window's first and
last quarters and its largest depth. The knee is the highest rate at
which the queue does not grow over the window.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

if __name__ == "__main__":
    _root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(_root), str(_root / "src")]

from vigbench import harness  # noqa: E402
from vigbench.readers import latencies_s, percentile  # noqa: E402


def sweep(cfg: dict, mix: dict, rates: list, seconds: float, seed: int, device):
    family = harness.load_family(cfg["family"])
    weights, _, pool_host = family.setup(cfg, seed, device)
    system = family.System(cfg, weights, pool_host, device)
    pool = pool_host.shape[0]
    family.warm(system, mix, pool)
    for rate in rates:
        w = harness.LOOPS[mix["loop"]](system, {**mix, "rate_per_s": rate},
                                       seconds, seed, pool)
        ctx = harness.Context(cfg=cfg, mix=mix, window=w, setup_s=0.0, trace=None)
        lat = latencies_s(ctx)
        q = [(t0 - w.start, depth) for t0, _, _, _, depth in w.ticks]
        first = [d for t, d in q if t < 0.25 * seconds]
        last = [d for t, d in q if t >= 0.75 * seconds]
        served = sum(1 for r in w.requests if r.done is not None and r.done <= w.end)
        yield {
            "rate_per_s": rate,
            "served_per_s": served / seconds,
            "p50_ms": 1e3 * percentile(lat, 0.5),
            "p95_ms": 1e3 * percentile(lat, 0.95),
            "queue_first_quarter": sum(first) / max(len(first), 1),
            "queue_last_quarter": sum(last) / max(len(last), 1),
            "queue_max": max((d for _, d in q), default=0),
            "failed": sum(1 for r in w.requests if r.failed),
            "lateness_s": w.lateness_s,
        }


def main(argv: list[str]) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell, conf = harness.find_cell(bench, args.workload)
    harness.require_cards(int(cell["chips"]))
    cfg = harness.load_json(harness.ROOT / conf["file"])
    mix = harness.load_json(harness.HERE / "traffic" / f"{cell['traffic']}.json")
    rates = [float(r) for r in args.rates.split(",")]
    for row in sweep(cfg, mix, rates, args.seconds, args.seed, "cuda"):
        print(json.dumps({"workload": args.workload, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
