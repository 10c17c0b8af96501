"""Multi-pod dry-run: trace every (arch x input-shape) cell on the
production meshes and record memory / cost / collective terms (port of
``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        [--arch ID ...] [--shape ID ...] [--multi-pod | --single-pod]
        [--out results/dryrun_torch] [--force]

JAX lowers and compiles each cell for 256 / 512 placeholder devices. The
port has no partitioner: it runs the cell's step once at full size on
``meta`` tensors (``launch/roofline.py::StepCounter``; no storage, no
process group, no card) over an ``abstract_mesh`` of the same shape. So:

* per-device FLOPs and bytes are the global program's counts divided by
  the chips (the port's values are global on every rank, ROADMAP queue 3,
  item 24); collective bytes are the parameter plan of
  ``roofline.collective_bytes``, a lower bound;
* argument and output bytes are exact for the layout the rules give: each
  leaf's ``Sharding.shard_shape``. Outputs take the rules of the inputs
  they replace (the train step's parameters and optimizer state, a
  decode cache) or, as a prefill's cache, ``shard_cache_tree``; logits
  and metrics ``shard_batch_tree``. No buffer is donated (alias 0);
* temp bytes are the full-depth trace's peak of live intermediates
  divided by the chips.

The full-depth trace gives the memory and ``per_device_scanned_raw`` (in
the port the full trace counts every layer: no loop is counted once).
Two probe traces at the depths ``_depth_unit`` gives give the per-layer
terms, extrapolated linearly to the full depth, as in JAX. A failing cell
is recorded with ``status: "error"`` and its traceback; ``main`` exits 1
when any cell erred. Records keep JAX's keys and mesh names, so
``launch/report.py`` of either package reads both. Results are cached per
cell as JSON, so reruns resume where they stopped.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import time
import traceback
from pathlib import Path
from typing import Optional

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, cell_supported, get_config
from repro_torch.launch import roofline as rl
from repro_torch.launch.api import get_api
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.launch.specs import make_cell, shard_batch_tree, shard_cache_tree
from repro_torch.models.module import Sharding

MESH_NAMES = {False: "pod16x16", True: "pod2x16x16"}


def production_mesh(multi_pod: bool):
    """The production mesh's description: (16, 16) over (data, model), or
    (2, 16, 16) over (pod, data, model)."""
    if multi_pod:
        return abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    return abstract_mesh((16, 16), ("data", "model"))


def _flat(tree) -> list:
    """The leaves of a tree of tuples / NamedTuples / dicts, in order."""
    if isinstance(tree, (torch.Tensor, Sharding)):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [x for item in tree for x in _flat(item)]


def sharded_bytes(values, shardings) -> int:
    """Per-device bytes of a tree of tensors under a tree of ``Sharding``
    leaves of the same structure."""
    vals, shs = _flat(values), _flat(shardings)
    if len(vals) != len(shs):
        raise ValueError(f"{len(vals)} leaves against {len(shs)} shardings")
    return sum(math.prod(s.shard_shape(v.shape)) * v.element_size()
               for v, s in zip(vals, shs))


def _out_shardings(cell, out, mesh):
    """Output shardings by the rules of the inputs (module docstring)."""
    rules = cell["rules"]
    if cell["kind"] == "train":
        params_sh, opt_sh, _ = cell["in_shardings"]
        return (params_sh, opt_sh, shard_batch_tree(out[2], mesh, rules))
    logits, cache = out
    return (shard_batch_tree(logits, mesh, rules), shard_cache_tree(cache, mesh))


def _trace(cell, traces: Optional[dict], shape_id: str) -> tuple:
    """(StepCounter, outputs) of one run of the cell's step. The trace does
    not depend on the mesh: ``traces`` (a dict, or None) keeps it by
    (config, shape) for the other mesh's cell."""
    key = (cell["cfg"], shape_id)
    if traces is not None and key in traces:
        return traces[key]
    with rl.StepCounter() as c:
        out = cell["fn"](*cell["args"])
    if traces is not None:
        traces[key] = (c, out)
    return c, out


def _measure(cell, mesh, shape_id: str, *, memory: bool = False,
             traces: Optional[dict] = None) -> dict:
    """Per-device terms of the cell's step and, with ``memory``, the
    per-device argument / output / temp bytes."""
    n = mesh.size
    c, out = _trace(cell, traces, shape_id)
    cfg = cell["cfg"]
    coll = rl.collective_bytes(get_api(cfg).param_spec(),
                               cell["in_shardings"][0], cell["kind"],
                               dtype=cfg.compute_dtype)
    meas = {"flops": c.flops / n, "hbm_bytes": c.bytes / n,
            "collective_bytes": coll}
    if memory:
        meas["memory"] = {
            "argument_bytes": sharded_bytes(cell["args"], cell["in_shardings"]),
            "output_bytes": sharded_bytes(out, _out_shardings(cell, out, mesh)),
            "temp_bytes": c.peak // n,
            "alias_bytes": 0,
        }
    return meas


def _depth_unit(cfg):
    """(unit size in layers, depths for the two probe traces)."""
    if cfg.family == "hybrid":
        u = len(cfg.hybrid.pattern)
        return u, (u, 2 * u)
    return 1, (2, 4)


def _with_depth(cfg, n_layers):
    return cfg.replace(num_layers=n_layers, scan_layers=False)


def _extrapolate(base: dict, probe_hi: dict, d_lo: int, d_hi: int,
                 full_layers: int, unit: int) -> dict:
    """Linear-in-depth extrapolation of per-device roofline terms: the
    probes at depths d_lo < d_hi give the per-layer cost, the totals at the
    real depth follow linearly (layer costs do not depend on depth)."""
    out = {}
    units_lo = d_lo / unit
    units_hi = d_hi / unit
    units_full = full_layers / unit
    for key in ("flops", "hbm_bytes", "collective_bytes"):
        per_unit = (probe_hi[key] - base[key]) / (units_hi - units_lo)
        out[key] = base[key] + per_unit * (units_full - units_lo)
    return out


def run_cell(arch: str, shape_id: str, *, multi_pod: bool, out_dir: Path,
             force: bool = False, cfg=None,
             traces: Optional[dict] = None) -> dict:
    """Trace one cell and write its record (see the module docstring).
    ``traces``: a dict shared by the calls of one (arch, shape) on both
    meshes, so each step is traced once."""
    mesh_name = MESH_NAMES[multi_pod]
    name = f"{arch}__{shape_id}__{mesh_name}"
    out_path = Path(out_dir) / f"{name}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    cfg = cfg or get_config(arch)
    ok, why = cell_supported(cfg, shape_id)
    rec = {
        "arch": arch, "shape": shape_id, "mesh": mesh_name,
        "kind": SHAPES[shape_id][2], "seq_len": SHAPES[shape_id][0],
        "global_batch": SHAPES[shape_id][1],
    }
    if not ok:
        rec.update({"status": "skipped", "reason": why})
        _write(out_path, rec)
        return rec

    t0 = time.time()
    try:
        mesh = production_mesh(multi_pod)
        n_chips = mesh.size
        # 1) the full-depth trace: the production config runs end to end
        #    and gives the memory.
        full = _measure(make_cell(arch, shape_id, mesh, cfg=cfg), mesh,
                        shape_id, memory=True, traces=traces)
        # 2) two probe traces -> per-layer terms.
        unit, (d_lo, d_hi) = _depth_unit(cfg)
        lo, hi = (_measure(make_cell(arch, shape_id, mesh,
                                     cfg=_with_depth(cfg, d)), mesh,
                           shape_id, traces=traces)
                  for d in (d_lo, d_hi))
        terms = _extrapolate(lo, hi, d_lo, d_hi, cfg.num_layers, unit)

        roof = rl.terms(terms["flops"], terms["hbm_bytes"],
                        terms["collective_bytes"])
        mf = rl.model_flops(cfg, rec["kind"], rec["seq_len"],
                            rec["global_batch"], n_chips)
        rec.update({
            "status": "ok",
            "compile_s": round(time.time() - t0, 1),
            "memory": full["memory"],
            "per_device": terms,
            "per_device_scanned_raw": {
                k: full[k] for k in ("flops", "hbm_bytes", "collective_bytes")},
            "roofline": {"compute_s": roof.compute_s, "memory_s": roof.memory_s,
                         "collective_s": roof.collective_s, "bound": roof.bound},
            "model_flops_per_chip": mf,
            "useful_flop_frac": (mf / terms["flops"]) if terms["flops"] else None,
        })
    except Exception as e:  # recorded, not swallowed: main exits 1
        rec.update({
            "status": "error",
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-4000:],
            "compile_s": round(time.time() - t0, 1),
        })
    _write(out_path, rec)
    return rec


def _write(path: Path, rec: dict):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=1, default=str))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="*", default=list(ARCH_IDS))
    ap.add_argument("--shape", nargs="*", default=list(SHAPES))
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    pods: list = []
    if args.single_pod or not args.multi_pod:
        pods.append(False)
    if args.multi_pod or not args.single_pod:
        pods.append(True)

    failures = 0
    recs = []
    for arch in args.arch:
        for shape_id in args.shape:
            for rec in run_meshes(arch, shape_id, pods=pods, out_dir=args.out,
                                  force=args.force):
                recs.append(rec)
                failures += rec["status"] == "error"
                print(describe(rec), flush=True)
    print(f"done; failures={failures}")
    if failures:
        raise SystemExit(1)
    return recs


def run_meshes(arch: str, shape_id: str, *, pods=(False, True),
               out_dir="results/dryrun_torch", force: bool = False) -> list:
    """``run_cell`` of one (arch, shape) on each mesh of ``pods`` (False:
    pod16x16, True: pod2x16x16), tracing each step once."""
    traces: dict = {}
    recs = [run_cell(arch, shape_id, multi_pod=mp, out_dir=Path(out_dir),
                     force=force, traces=traces) for mp in pods]
    del traces
    gc.collect()
    return recs


def describe(rec: dict) -> str:
    """One line of a record, as JAX's driver prints it."""
    head = f"{rec['arch']} {rec['shape']} mp={rec['mesh'] == MESH_NAMES[True]}"
    if rec["status"] == "error":
        return f"[FAIL] {head}: {rec['error']}"
    extra = ""
    if rec["status"] == "ok":
        r = rec["roofline"]
        extra = (f" bound={r['bound']} c={r['compute_s']:.2e}s"
                 f" m={r['memory_s']:.2e}s x={r['collective_s']:.2e}s"
                 f" trace={rec['compile_s']}s")
    return f"[{rec['status'].upper()}] {head}{extra}"


if __name__ == "__main__":
    main()
