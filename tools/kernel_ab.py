#!/usr/bin/env python3
"""Time the port's CUDA kernels against an earlier build of their sources,
on one card, in one process.

    python3 tools/kernel_ab.py --baseline DIR

With ``--forward`` it also runs ``chip_smoke.forward_time`` (the B = 8
``vig_ti_pyr`` forward through the ``cuda`` tier: time and the profiled
device time with the DIGC and MRConv kernels' share) on each library in
the same turns.

DIR holds the earlier ``digc_topk.cu`` and ``mrconv.cu`` (for example a
``git archive`` of an earlier commit's ``src/repro_torch/kernels/csrc``,
unpacked into a directory that ``.gitignore`` lists). Both libraries are
built with nvcc; each kernel is timed through the same wrappers
(``digc_topk_cuda``, ``mrconv_cuda``) at the main-path shapes (B = 8)
and the causal KNN shape, with ``chip_smoke.time_ms`` (CUDA events,
calls queued behind a device sleep), in turns: baseline, current,
current, baseline. MRConv is also timed on one 4-feature row with k = 1
(the least a launch of it takes in this timing) and at the iso shape
with k = 1 (one gather a lane). Prints one line a case and a JSON
summary of the medians in microseconds.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.digc_topk import digc_topk_cuda  # noqa: E402
from repro_torch.kernels.mrconv import mrconv_cuda  # noqa: E402


def cases() -> list:
    """(name, fn(x, y, idx)) at each shape: (B, N, M, D, kd or k)."""
    digc, mr = chip_smoke.main_path_shapes("vig_ti_iso", "vig_ti_pyr")
    out = []
    for n, m, d, kd in sorted(digc):
        for vname, kw in (("exact", {}), ("packed", dict(packed=True)),
                          ("mxu_bf16", dict(mxu_bf16=True)),
                          ("legacy", dict(kernel_merge="legacy")),
                          ("bucket_rounds", dict(
                              chip_smoke.BUCKET_SPEC,
                              block_m=chip_smoke.bucket_tiles(m, kd)[1]
                              or chip_smoke.bucket_tiles(m, kd)[0]))):
            out.append((f"digc {vname}", (8, n, m, d, kd),
                        lambda x, y, i, kd=kd, kw=kw: digc_topk_cuda(x, y, kd, **kw)))
    h, s, dh, nn = (chip_smoke.KNN[k] for k in ("heads", "seq", "dh", "nn"))
    out.append(("digc causal", (h, s, s, dh, nn),
                lambda x, y, i: digc_topk_cuda(x, y, nn, causal=True)))
    for b, (n, m, d, k) in [(8, shape) for shape in sorted(mr)] + [
            (1, (1, 1, 4, 1)), (8, (196, 196, 192, 1))]:
        out.append(("mrconv", (b, n, m, d, k),
                    lambda x, y, i: mrconv_cuda(x, y, i)))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, required=True)
    ap.add_argument("--only", default="",
                    help="time only the cases whose name contains this")
    ap.add_argument("--forward", action="store_true",
                    help="also the B = 8 vig_ti_pyr forward on each library")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    libs = {"current": _build.load(),
            "baseline": _build.build(args.baseline.resolve(),
                                     ROOT / "build" / "kernel_ab")}
    chip_smoke.calibrate_sleep()
    print(smi)
    dev = chip_smoke.DEV
    summary = []
    for name, (b, n, m, d, k), fn in cases():
        if args.only not in name:
            continue
        x = torch.from_numpy(testing.features(1, b, n, d)).to(dev)
        y = torch.from_numpy(testing.features(2, b, m, d)).to(dev)
        idx = torch.from_numpy(testing.neighbour_ids(3, b, n, k, m)).to(dev)
        times: dict = {"baseline": [], "current": []}
        for side in ("baseline", "current", "current", "baseline"):
            with _build.use(libs[side]):
                times[side].append(
                    chip_smoke.time_ms(lambda: fn(x, y, idx))[0] * 1e3)
        med = {s: statistics.median(t) for s, t in times.items()}
        summary.append({"kernel": name, "shape": [b, n, m, d, k], **med})
        print(f"{name:20s} {[b, n, m, d, k]}: baseline {med['baseline']:.1f} us, "
              f"current {med['current']:.1f} us "
              f"({med['baseline'] / med['current']:.2f}x)")
    forwards = []
    if args.forward:
        from repro_torch.models import convert, vig

        cfg = vig.VIG_VARIANTS["vig_ti_pyr"]
        params = convert.init_params(
            cfg, generator=torch.Generator().manual_seed(1), device=dev)
        batch = chip_smoke.to_dev(testing.images(100, 8, cfg.image_size))
        for side in ("baseline", "current", "current", "baseline"):
            print(f"forward on the {side} library:")
            with _build.use(libs[side]):
                forwards.append({"library": side, **chip_smoke.forward_time(
                    params, batch, cfg)})
    print(json.dumps({"card": smi, "ab_us": summary, "forward": forwards}))


if __name__ == "__main__":
    main()
