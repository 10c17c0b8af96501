#!/usr/bin/env python3
"""Time the ``overlap`` reuse policy with its refresh build forked onto
the card's side stream (``core.digc.RefreshFork``, as the package runs
it) against the same refresh on the current stream, through captured
bucket programs on one card.

    python3 tools/overlap_fork_ab.py [--rounds 3]

The trace is ``chip_smoke.py``'s phase 15: ``vig_ti_iso`` at full width
on the ``blocked`` tier, eight video tenants and one tenant with a new
image every frame, bucket 16, ``reuse="overlap"``. Each round serves it
on four new engines in turns (fork, current, current, fork); each
engine's first tick captures its program, the current-stream arm's with
``RefreshFork.run`` running the refresh in place. Prints the card's name
and power limit, the median tick of ticks 2 and later per arm, and
whether every request's logits agree bit for bit across the arms.
"""

from __future__ import annotations

import argparse
import contextlib
import statistics
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.core import DigcSpec  # noqa: E402
from repro_torch.core.digc import RefreshFork  # noqa: E402
from repro_torch.models import convert, vig  # noqa: E402
from repro_torch.serve.engine import VigServeEngine  # noqa: E402


def in_place():
    """Capture with the refresh on the current stream."""
    return mock.patch.object(RefreshFork, "run",
                             lambda self, x3, fn, inputs: fn())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    _, smi = chip_smoke.card_and_software()
    cfg = vig.VIG_VARIANTS["vig_ti_iso"]
    params = convert.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                 device=chip_smoke.DEV)
    frames = chip_smoke.video_frames(cfg.image_size)
    spec = DigcSpec(impl="blocked", k=cfg.k, reuse="overlap", drift_tau=1e-5,
                    max_stale=4)

    def serve(forked: bool) -> dict:
        eng = VigServeEngine(cfg, params, digc_impl=spec, autotune=False,
                             buckets=(1, 2, 4, 8, 16), device=chip_smoke.DEV)
        with contextlib.nullcontext() if forked else in_place():
            res = chip_smoke.serve_video(eng, frames)
        chip_smoke.assert_no_faults(eng, f"overlap, forked={forked}")
        return res

    ms: dict = {True: [], False: []}
    logits: dict = {}
    for _ in range(args.rounds):
        for forked in (True, False, False, True):
            res = serve(forked)
            ms[forked] += res["ms"][1:]
            got = np.stack([r.logits for reqs in res["reqs"] for r in reqs])
            if not np.array_equal(logits.setdefault(forked, got), got):
                raise AssertionError(f"forked={forked}: logits differ "
                                     "between engines")
    same = np.array_equal(logits[True], logits[False])
    f, c = statistics.median(ms[True]), statistics.median(ms[False])
    print(smi)
    print(f"overlap, captured, median tick over {len(ms[True])} ticks each, "
          f"in turns: refresh on a side stream {f:.3f} ms, on the current "
          f"stream {c:.3f} ms ({100 * (f / c - 1):+.1f}%); logits bit for "
          f"bit across the arms: {same}")
    if not same:
        raise AssertionError("the forked refresh changed the logits")


if __name__ == "__main__":
    main()
