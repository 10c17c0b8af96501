"""Readings behind the correctness limits, at a cell's own size.

    python vigbench/control.py --workloads <cell>[,<cell>...] --seeds 1,2,3 --seconds 3

For each cell and seed, in one process: the cell's program serves the
cell's traffic for ``--seconds`` and its answers are held against the
plain reference (the program's reading). Then each of the family's
controls (``family.controls``: for the ViG family the reference in TF32
put in the program's place, and the program's answers broken in the
upper half of every bucket's lanes) is held against the same reference.
Prints one JSON line per cell and seed with each side's held numbers
(``family.held``); ``family.CONTROL_BREAKS`` names the limit that each
control must exceed.
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


def broken_window(window, how: str):
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


def readings(cfg: dict, mix: dict, limits: dict, seed: int, seconds: float,
             device) -> dict:
    """The program's held numbers and each of its family's controls' for
    one seed. ``reference_s`` is the reference's time with the program's
    comparison (a reference that teacher-forces works as it compares)."""
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
    program = family.held(window, ref, limits)
    out = {"seed": seed, "requests": len(window.requests),
           "reference_s": time.perf_counter() - t0, "program": program}
    for name, broken in family.controls(cfg, weights, pool_dev, window, ref).items():
        out[name] = family.held(broken, ref, limits)
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
