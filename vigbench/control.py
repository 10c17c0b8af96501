"""Readings behind the correctness limits, at a cell's own size.

    python vigbench/control.py --workloads <cell>[,<cell>...] --seeds 1,2,3 --seconds 3

For each cell and seed, in one process: the cell's program serves the
cell's traffic for ``--seconds`` and every answer is compared with the
plain reference (the program's reading). Then, on the same requests, the
reference computed in TF32 (``vig_plain``'s ``precision="tf32"``) is put
in the program's place (the control's reading), and the program's own
answers are broken in the upper half of every bucket's lanes: each such
lane returns the answer of the tick's first lane (``upper_lanes_other``)
or all zeros (``upper_lanes_zero``). Prints one JSON line per cell and
seed with each side's held numbers and quantiles of its gaps.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

if __name__ == "__main__":
    _root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(_root), str(_root / "src")]

from vigbench import harness  # noqa: E402


def break_upper_lanes(done: list, how: str) -> list:
    """One tick's answers, ``(uid, answer, (bucket, row))``, with every
    row in the upper half of the bucket answered wrongly: by the answer
    of row 0 (``other``) or by zeros (``zero``)."""
    first = next((a for _, a, lane in done if lane is not None and lane[1] == 0), None)
    out = []
    for uid, answer, lane in done:
        if answer is not None and lane is not None and 2 * lane[1] >= lane[0]:
            answer = first if how == "other" else np.zeros_like(answer)
        out.append((uid, answer, lane))
    return out


def _broken(window, how: str):
    """The window with its ticks' answers broken as ``break_upper_lanes``
    does (a tick's requests share their start)."""
    ticks = defaultdict(list)
    for r in window.requests:
        ticks[r.start].append(r)
    reqs = []
    for tick in ticks.values():
        done = break_upper_lanes([(r.uid, r.answer, r.lane) for r in tick], how)
        reqs += [dataclasses.replace(r, answer=a) for r, (_, a, _) in zip(tick, done)]
    return dataclasses.replace(window, requests=reqs)


def _numbers(family, window, ref, limits) -> dict:
    by_lane, missing = family.answer_gaps(window, ref)
    gaps = [g for lane in by_lane.values() for g in lane]
    held = family.lane_quartiles(by_lane, int(limits["lane_min_answers"]))
    q = np.quantile(gaps, [0.25, 0.5, 0.75])
    return {"missing": missing, "gap_q25_worst_lane": max(held.values()),
            "lanes_held": len(held),
            "least_answers_in_a_lane": min(len(g) for g in by_lane.values()),
            "gap_q25": float(q[0]), "gap_median": float(q[1]),
            "gap_q75": float(q[2]), "gap_max": max(gaps)}


def readings(cfg: dict, mix: dict, limits: dict, seed: int, seconds: float,
             device) -> dict:
    """The program's numbers, the TF32 control's and the broken lanes'
    for one seed."""
    import gc

    import torch

    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["allow_tf32"])
    family = harness.load_family(cfg["family"])
    weights, pool_dev, pool_host = family.setup(cfg, seed, device)
    system = family.System(cfg, weights, pool_host, device)
    pool = pool_host.shape[0]
    family.warm(system, mix, pool)
    window = harness.LOOPS[mix["loop"]](system, mix, seconds, seed, pool)
    del system
    gc.collect()
    t0 = time.perf_counter()
    ref = family.reference(cfg, weights, pool_dev)
    ref_s = time.perf_counter() - t0
    low = family.reference(cfg, weights, pool_dev, "tf32")
    control = dataclasses.replace(window, requests=[
        dataclasses.replace(r, answer=low[r.item], failed=False)
        for r in window.requests])
    out = {"seed": seed, "requests": len(window.requests), "reference_s": ref_s,
           "program": _numbers(family, window, ref, limits),
           "control_tf32": _numbers(family, control, ref, limits)}
    for how in ("other", "zero"):
        out[f"upper_lanes_{how}"] = _numbers(family, _broken(window, how), ref, limits)
    return out


def main(argv: list[str]) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workloads", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for workload in args.workloads.split(","):
        cell, conf = harness.find_cell(bench, workload)
        harness.require_cards(int(cell["chips"]))
        cfg = harness.load_json(harness.ROOT / conf["file"])
        mix = harness.load_json(harness.HERE / "traffic" / f"{cell['traffic']}.json")
        limits = harness.load_json(harness.HERE / "limits" / f"{conf['name']}.json")
        for seed in (int(s) for s in args.seeds.split(",")):
            out = readings(cfg, mix, limits, seed, args.seconds, "cuda")
            print(json.dumps({"workload": workload, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
