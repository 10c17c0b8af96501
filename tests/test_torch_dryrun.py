"""The port's dry-run tooling (``repro_torch/launch/{specs,roofline,
dryrun,report}.py``) against the JAX package's on the CPU.

* Specs: JAX's ``make_cell`` for all 64 cells on both production meshes
  (512 forced host devices, in a subprocess) against the port's on
  ``abstract_mesh``: every argument leaf's path, shape, dtype and spec
  entries equal, and ``Sharding.shard_shape`` equal to
  ``NamedSharding.shard_shape``; 64 built, 16 skipped.
* ``active_param_count`` / ``model_flops``: equal integers for every arch
  and shape.
* ``analyze``'s FLOPs against XLA's ``cost_analysis()["flops"]`` of the
  same SMOKE cell (unrolled layers, sequence 64 within one query chunk)
  on one CPU device, for a dense, a MoE and an SSM arch, decode and
  train. Measured first: the port counts 0.52-0.65 of XLA's FLOPs at
  decode and 0.60-0.90 at train (matrix products agree; XLA counts more
  elementwise work, ROADMAP queue 3, item 30). Tolerance: the ratio in
  [0.45, 1.0].
* ``_extrapolate`` equals JAX's on the same numbers; ``run_cell`` writes
  records with JAX's keys; ``report.table`` / ``summary`` / ``compare``
  give JAX's strings on the same records.
"""

import json
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from _subproc import run_snippet  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import report as jreport  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch.mesh import make_mesh as jax_make_mesh  # noqa: E402
from repro.models.module import use_mesh as jax_use_mesh  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun, report, roofline, specs  # noqa: E402
from repro_torch.launch.mesh import abstract_mesh  # noqa: E402
from repro_torch.models.module import Sharding  # noqa: E402

JAX_CELLS = """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import json
    import jax
    from repro.configs import ARCH_IDS, SHAPES, cell_supported, get_config
    from repro.launch.dryrun import _extrapolate
    from repro.launch.mesh import make_production_mesh
    from repro.launch.specs import make_cell

    def name(k):
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                return str(getattr(k, attr))
        raise TypeError(k)

    def entry(e):
        return list(e) if isinstance(e, tuple) else e

    out = {"cells": {}, "skipped": 0}
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        for arch in ARCH_IDS:
            for shape in SHAPES:
                if not cell_supported(get_config(arch), shape)[0]:
                    out["skipped"] += 1
                    continue
                cell = make_cell(arch, shape, mesh)
                leaves = jax.tree_util.tree_flatten_with_path(cell["args"])[0]
                shs = jax.tree_util.tree_leaves(cell["in_shardings"])
                out["cells"][f"{arch}|{shape}|{int(multi_pod)}"] = {
                    "/".join(name(k) for k in path): [
                        list(leaf.shape), str(leaf.dtype),
                        [entry(e) for e in sh.spec],
                        list(sh.shard_shape(leaf.shape))]
                    for path, leaf, sh in zip(*zip(*leaves), shs)}
    lo = {"flops": 1.5e9, "hbm_bytes": 7.25e8, "collective_bytes": 3.0e6}
    hi = {"flops": 2.75e9, "hbm_bytes": 9.5e8, "collective_bytes": 5.5e6}
    out["extrapolate"] = [_extrapolate(lo, hi, 2, 4, 48, 1),
                          _extrapolate(lo, hi, 3, 6, 38, 3)]
    print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_cells():
    proc = run_snippet(JAX_CELLS, devices=None, timeout=900)
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _port_leaves(tree, path=()):
    """{path: (tensor or Sharding)} with JAX's key names: dict keys,
    NamedTuple field names, sequence indices."""
    if isinstance(tree, (torch.Tensor, Sharding)):
        return {"/".join(path): tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        items = enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_port_leaves(v, path + (str(k),)))
    return out


def _entry(e):
    return list(e) if isinstance(e, tuple) else e


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod16x16", "pod2x16x16"])
def test_make_cell_leaves_equal_jax(jax_cells, multi_pod):
    mesh = dryrun.production_mesh(multi_pod)
    assert mesh.size == (512 if multi_pod else 256)
    built = skipped = 0
    for arch in configs.ARCH_IDS:
        for shape in configs.SHAPES:
            if not configs.cell_supported(configs.get_config(arch), shape)[0]:
                skipped += 1
                continue
            cell = specs.make_cell(arch, shape, mesh)
            args = _port_leaves(cell["args"])
            shs = _port_leaves(cell["in_shardings"])
            assert args.keys() == shs.keys(), (arch, shape)
            got = {p: [list(t.shape), str(t.dtype).replace("torch.", ""),
                       [_entry(e) for e in shs[p].spec],
                       list(shs[p].shard_shape(t.shape))]
                   for p, t in args.items()}
            assert all(t.device.type == "meta" for t in args.values())
            want = jax_cells["cells"][f"{arch}|{shape}|{int(multi_pod)}"]
            assert got.keys() == want.keys(), (arch, shape,
                                               sorted(got.keys() ^ want.keys()))
            for p in want:
                assert got[p] == want[p], (arch, shape, p, got[p], want[p])
            built += 1
    assert (built, skipped) == (32, 8)
    assert jax_cells["skipped"] == 16 and len(jax_cells["cells"]) == 64


def test_shard_shape_raises_where_an_axis_does_not_divide():
    mesh = abstract_mesh((16, 16), ("data", "model"))
    sh = Sharding(mesh, (("data", "model"), None))
    assert sh.shard_shape((512, 3)) == (2, 3)
    with pytest.raises(ValueError, match="not divisible"):
        sh.shard_shape((48, 3))


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_counts_and_model_flops_equal_jax(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    assert roofline.active_param_count(cfg) == jroofline.active_param_count(jcfg)
    for seq, batch, kind in configs.SHAPES.values():
        for chips in (256, 512):
            assert roofline.model_flops(cfg, kind, seq, batch, chips) == \
                jroofline.model_flops(jcfg, kind, seq, batch, chips)


# One query chunk (q_chunk 512) and unrolled layers: XLA counts a loop's
# body once, so neither package's step may hold a loop.
SMOKE_SHAPES = {"smoke_decode": (64, 4, "decode"), "smoke_train": (64, 4, "train")}


@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-v2-lite-16b", "mamba2-370m"])
@pytest.mark.parametrize("shape", list(SMOKE_SHAPES))
def test_analyze_flops_within_tolerance_of_xla(arch, shape, monkeypatch):
    for table in (configs.SHAPES, jconfigs.SHAPES):
        monkeypatch.setitem(table, shape, SMOKE_SHAPES[shape])
    jcfg = jconfigs.get_smoke(arch).replace(scan_layers=False)
    jmesh = jax_make_mesh((1, 1), ("data", "model"))
    jcell = jspecs.make_cell(arch, shape, jmesh, cfg=jcfg)
    with jax_use_mesh(jmesh, jcell["rules"]):
        compiled = jax.jit(jcell["fn"], in_shardings=jcell["in_shardings"]).lower(
            *jcell["args"]).compile()
    cost = compiled.cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    xla = float(cost["flops"])
    cfg = configs.get_smoke(arch).replace(scan_layers=False)
    cell = specs.make_cell(arch, shape, abstract_mesh((1, 1), ("data", "model")),
                           cfg=cfg)
    roof = roofline.analyze(cell["fn"], *cell["args"])
    assert 0.45 <= roof.flops / xla <= 1.0, (roof.flops, xla)
    assert roof.bound in ("compute", "memory", "collective")
    assert roof.compute_s == roof.flops / roofline.PEAK_FLOPS


def test_extrapolate_equals_jax(jax_cells):
    lo = {"flops": 1.5e9, "hbm_bytes": 7.25e8, "collective_bytes": 3.0e6}
    hi = {"flops": 2.75e9, "hbm_bytes": 9.5e8, "collective_bytes": 5.5e6}
    got = [dryrun._extrapolate(lo, hi, 2, 4, 48, 1),
           dryrun._extrapolate(lo, hi, 3, 6, 38, 3)]
    assert got == jax_cells["extrapolate"]


JAX_KEYS = {"arch", "shape", "mesh", "kind", "seq_len", "global_batch", "status",
            "compile_s", "memory", "per_device", "per_device_scanned_raw",
            "coll_by_kind", "roofline", "model_flops_per_chip",
            "useful_flop_frac"}


@pytest.fixture(scope="module")
def olmo_records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_torch")
    recs = dryrun.main(["--arch", "olmo-1b", "--single-pod", "--out", str(out)])
    return out, recs


def test_run_cell_records_keep_jax_keys(olmo_records):
    out, recs = olmo_records
    assert [r["status"] for r in recs] == ["ok", "ok", "ok", "skipped"]
    for rec in recs[:3]:
        # JAX's record minus its HLO-only collective split
        assert set(rec) == JAX_KEYS - {"coll_by_kind"}, sorted(rec)
        assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                      "temp_bytes", "alias_bytes"}
        assert rec["mesh"] == "pod16x16"
        assert rec["memory"]["argument_bytes"] > 0 and rec["memory"]["temp_bytes"] > 0
        per, raw = rec["per_device"], rec["per_device_scanned_raw"]
        # the full trace counts every layer: the extrapolation lands on it
        # (within 1e-3: the train step also has work that is not layers)
        for key in ("flops", "hbm_bytes", "collective_bytes"):
            assert math.isclose(per[key], raw[key], rel_tol=1e-3), (key, per, raw)
        assert rec["roofline"]["bound"] in ("compute", "memory", "collective")
    cached = dryrun.run_cell("olmo-1b", "decode_32k", multi_pod=False, out_dir=out)
    assert cached == json.loads(json.dumps(recs[2]))
    assert len(list(out.glob("*.json"))) == 4


def test_run_cell_records_an_error_and_main_exits_1(tmp_path, monkeypatch):
    def broken(*a, **kw):
        raise RuntimeError("planted")

    monkeypatch.setattr(dryrun, "make_cell", broken)
    rec = dryrun.run_cell("olmo-1b", "train_4k", multi_pod=True, out_dir=tmp_path)
    assert rec["status"] == "error" and "planted" in rec["error"]
    assert "Traceback" in rec["traceback"]
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "olmo-1b", "--shape", "train_4k", "--multi-pod",
                     "--out", str(tmp_path / "again")])
    assert exc.value.code == 1


def test_report_strings_equal_jax(olmo_records, tmp_path):
    out, recs = olmo_records
    assert report.summary(recs) == jreport.summary(recs) == {
        "ok": 3, "skipped": 1, "error": 0}
    for mesh in ("pod16x16", "pod2x16x16"):
        assert report.table(recs, mesh) == jreport.table(recs, mesh)
    # an optimized copy: every dominant term halved
    opt = tmp_path / "opt"
    opt.mkdir()
    for p in out.glob("*.json"):
        rec = json.loads(p.read_text())
        if rec["status"] == "ok":
            rec["roofline"] = {k: (v / 2 if k.endswith("_s") else v)
                               for k, v in rec["roofline"].items()}
        (opt / p.name).write_text(json.dumps(rec))
    table = report.compare(out, opt)
    assert table == jreport.compare(out, opt)
    assert table.count("2.00x") == 3
    for rec in recs[:3]:
        sentence = report.bottleneck_sentence(rec)
        assert "MXU" not in sentence and "ICI" not in sentence
