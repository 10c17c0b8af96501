"""The roofline table from dry-run JSONs (port of
``repro/launch/report.py``; it reads the records of either package's
dry-run: the keys and mesh names are the same).

    PYTHONPATH=src python -m repro_torch.launch.report results/dryrun_torch
    PYTHONPATH=src python -m repro_torch.launch.report BASE OPT --compare
"""

from __future__ import annotations

import json
import sys
from pathlib import Path


def fmt_s(v):
    if v is None:
        return "-"
    if v == 0:
        return "0"
    return f"{v:.2e}"


def load(out_dir: Path):
    recs = []
    for p in sorted(Path(out_dir).glob("*.json")):
        recs.append(json.loads(p.read_text()))
    return recs


def bottleneck_sentence(rec) -> str:
    r = rec.get("roofline") or {}
    b = r.get("bound")
    kind = rec["kind"]
    if b == "collective":
        if kind == "train":
            return ("FSDP all-gathers + grad reduce-scatters over InfiniBand "
                    "dominate; keep gathers inside the NVLink domain / overlap")
        return ("decode all-gathers of sharded weights over InfiniBand dominate; "
                "widen batch-per-GPU or keep the model axis within NVLink")
    if b == "memory":
        if kind == "decode":
            return "KV/state cache sweep is inherent at batch-bound decode; raise batch or quantize cache"
        return "HBM-bound: increase arithmetic intensity (fusion, larger per-GPU batch)"
    return "compute-bound: already at the tensor-core roofline; only algorithmic cuts help"


def table(recs, mesh: str) -> str:
    rows = [
        "| arch | shape | kind | compute s | memory s | collective s | bound | MODEL/HLO flops | per-dev HBM GB |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for rec in recs:
        if rec["mesh"] != mesh:
            continue
        if rec["status"] == "skipped":
            rows.append(
                f"| {rec['arch']} | {rec['shape']} | {rec['kind']} | - | - | - | "
                f"SKIP | - | - |"
            )
            continue
        if rec["status"] == "error":
            rows.append(
                f"| {rec['arch']} | {rec['shape']} | {rec['kind']} | - | - | - | "
                f"ERROR | - | - |"
            )
            continue
        r = rec["roofline"]
        uf = rec.get("useful_flop_frac")
        mem = rec["memory"]["temp_bytes"] / 1e9
        rows.append(
            f"| {rec['arch']} | {rec['shape']} | {rec['kind']} | "
            f"{fmt_s(r['compute_s'])} | {fmt_s(r['memory_s'])} | "
            f"{fmt_s(r['collective_s'])} | **{r['bound']}** | "
            f"{uf:.2f} | {mem:.1f} |"
        )
    return "\n".join(rows)


def summary(recs) -> dict:
    out = {"ok": 0, "skipped": 0, "error": 0}
    for r in recs:
        out[r["status"]] += 1
    return out


def compare(base_dir: Path, opt_dir: Path, mesh: str = "pod16x16") -> str:
    """Baseline vs optimized dominant-term table."""
    base = {(r["arch"], r["shape"]): r for r in load(base_dir)
            if r["mesh"] == mesh}
    opt = {(r["arch"], r["shape"]): r for r in load(opt_dir)
           if r["mesh"] == mesh}
    rows = [
        "| arch | shape | baseline bound | baseline s | optimized bound | optimized s | gain |",
        "|---|---|---|---|---|---|---|",
    ]
    for key, o in sorted(opt.items()):
        b = base.get(key)
        if not b or b["status"] != "ok" or o["status"] != "ok":
            continue
        rb, ro = b["roofline"], o["roofline"]
        tb = rb[f"{rb['bound']}_s"]
        to = ro[f"{ro['bound']}_s"]
        gain = tb / to if to else float("inf")
        rows.append(
            f"| {key[0]} | {key[1]} | {rb['bound']} | {fmt_s(tb)} | "
            f"{ro['bound']} | {fmt_s(to)} | {gain:.2f}x |"
        )
    return "\n".join(rows)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) > 2 and argv[2] == "--compare":
        print(compare(Path(argv[0]), Path(argv[1])))
        return
    out_dir = Path(argv[0] if argv else "results/dryrun_torch")
    recs = load(out_dir)
    print("## Dry-run summary:", summary(recs))
    for mesh in ("pod16x16", "pod2x16x16"):
        print(f"\n### Mesh {mesh}\n")
        print(table(recs, mesh))
    print("\n### Bottleneck notes\n")
    seen = set()
    for rec in recs:
        if rec["status"] != "ok" or rec["mesh"] != "pod16x16":
            continue
        key = (rec["arch"], rec["shape"])
        if key in seen:
            continue
        seen.add(key)
        print(f"- **{rec['arch']} / {rec['shape']}** "
              f"({rec['roofline']['bound']}-bound): {bottleneck_sentence(rec)}")


if __name__ == "__main__":
    main()
