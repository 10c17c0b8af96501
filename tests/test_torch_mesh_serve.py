"""Mesh-native serving (``VigServeEngine(mesh=)``, DESIGN.md §10) on the
port.

The JAX package's sharded-engine tests (``tests/test_serve_sharded.py``
and ``test_serve_multires.py::test_mesh_tick_padding_serves_nondividing_bucket``)
fail under JAX 0.9's typed shardings before they check anything, so no
JAX output exists to compare with: the port is held to their stated
contracts against its own results instead, on 4 gloo ranks
(``testing.run_ranks``), each rank running the same engine on the same
trace:

* a ragged 3-tenant trace on buckets (1, 2) over a 4-rank ring: every
  request bit for bit its tenant's B = 1 replay on the same mesh, at most
  2 programs, and the construction bitwise the single-device ``blocked``
  tier; each request within 1e-5 of the unsharded ``blocked`` B = 1
  forward (JAX's tolerance: a B > 1 batch reassociates sums);
* parking through slot churn: an evicted tenant comes back warm (bit for
  bit its full-history replay, its row counters continued), and with
  ``park_capacity=0`` cold (a fresh replay, its counters restarted);
* bucket 3 on a (2, 2) ("ring", "data") mesh pads its tick to width 4;
  each request within 1e-5 of its B = 1 replay; a bucket below the batch
  axis is refused.

The construction errors of ``tests/test_serve_multitenant.py:315-330``
run in-process on one-rank meshes, with JAX's messages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import testing  # noqa: E402
from repro_torch.core import DigcSpec  # noqa: E402
from repro_torch.core.tuner import VigSchedule  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import convert, vig  # noqa: E402
from repro_torch.serve.engine import VigRequest, VigServeEngine  # noqa: E402

CPU = "cpu"


def _tiny():
    cfg = vig.VIG_VARIANTS["vig_ti_iso"].replace(
        image_size=16, patch=4, embed_dims=(16,), depths=(2,), num_classes=3,
        k=3, digc_impl="ring")
    params = convert.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                 device=CPU)
    return cfg, params


def test_mesh_mode_rejects_invalid_configurations():
    """Non-distributed impls have no mesh knobs; a sharded batch axis
    needs a bucket set; a pre-tuned schedule carries its own per-stage
    placement."""
    cfg, params = _tiny()
    mesh = make_mesh((1,), ("data",), device=CPU)
    with pytest.raises(ValueError, match="mesh-native"):
        VigServeEngine(cfg, params, digc_impl="blocked", autotune=False,
                       mesh=mesh, device=CPU)
    with pytest.raises(ValueError, match="bucket set"):
        VigServeEngine(cfg, params, digc_impl="ring", autotune=False,
                       mesh=mesh, mesh_batch_axis="data", buckets=None,
                       device=CPU)
    sched = VigSchedule((DigcSpec(impl="ring", k=3, mesh=mesh),))
    with pytest.raises(ValueError, match="VigSchedule"):
        VigServeEngine(cfg, params, digc_impl=sched, autotune=False,
                       mesh=mesh, device=CPU)


def test_one_rank_mesh_engine_equals_the_unsharded_engine():
    """On one rank the mesh engine serves the blocked engine's logits bit
    for bit (the ring's lists equal the blocked tier's on these inputs),
    reports its mesh and keeps the bucket programs."""
    cfg, params = _tiny()
    mesh = make_mesh((1,), ("data",), device=CPU)
    rng = np.random.default_rng(3)
    images = [rng.standard_normal((16, 16, 3)).astype(np.float32)
              for _ in range(5)]
    out = {}
    for impl, kw in (("ring", dict(mesh=mesh)), ("blocked", {})):
        eng = VigServeEngine(cfg, params, digc_impl=impl, autotune=False,
                             buckets=(1, 2), device=CPU, **kw)
        reqs = [VigRequest(uid=i, image=im, tenant=f"t{i % 3}")
                for i, im in enumerate(images)]
        for wave in (reqs[:2], reqs[2:3], reqs[3:]):
            for r in wave:
                eng.submit(r)
            assert eng.step() == len(wave)
        out[impl] = (np.stack([r.logits for r in reqs]), eng.stats())
    np.testing.assert_array_equal(out["ring"][0], out["blocked"][0])
    assert out["ring"][1]["mesh"] == {"data": 1}
    assert out["blocked"][1]["mesh"] is None
    assert out["ring"][1]["compile_count"] == 2


RANK_BODY = """
import numpy as np, torch
from repro_torch.core import DigcSpec, digc
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import convert, vig
from repro_torch.serve.engine import VigRequest, VigServeEngine
cfg = vig.VIG_VARIANTS["vig_ti_iso"].replace(
    image_size=16, patch=4, embed_dims=(16,), depths=(2,), num_classes=3,
    k=3, digc_impl="ring")
params = convert.init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
out = {{}}

def replay(reqs, mesh, axis):
    spec = DigcSpec(impl="ring", mesh=mesh, axis_name=axis)
    state = vig.init_vig_state(cfg, 1, spec, per_slot=True, mesh=mesh,
                               mesh_axis=axis, device="cpu")
    logits = []
    for r in reqs:
        lg, state = vig.vig_forward(params, torch.from_numpy(r.image)[None],
                                    cfg, digc_impl=spec, state=state)
        logits.append(lg[0].numpy())
    return np.stack(logits)

def blocked(reqs):
    return np.stack([vig.vig_forward(params, torch.from_numpy(r.image)[None],
                                     cfg, digc_impl="blocked")[0].numpy()
                     for r in reqs])

# (a) ragged 3-tenant trace, buckets (1, 2), 4-rank ring
ring = make_mesh((4,), ("ring",), device="cpu")
rng = np.random.default_rng(7)
img = lambda: rng.standard_normal((16, 16, 3)).astype(np.float32)
compiled = []
eng = VigServeEngine(cfg, params, digc_impl="ring", autotune=False,
                     buckets=(1, 2), mesh=ring, mesh_axis="ring",
                     on_compile=compiled.append, device="cpu")
per_t, uid, buckets = {{}}, 0, []
for w in [["A"], ["B", "C"], ["A", "B"], ["C"], ["B", "A"]]:
    for t in w:
        r = VigRequest(uid=uid, image=img(), tenant=t)
        uid += 1
        per_t.setdefault(t, []).append(r)
        eng.submit(r)
    assert eng.step() == len(w)
    buckets.append((eng.last_bucket, eng.bucket_for(len(w))))
for t, reqs in sorted(per_t.items()):
    out[f"a_{{t}}"] = np.stack([r.logits for r in reqs])
    out[f"a_{{t}}_replay"] = replay(reqs, ring, "ring")
    out[f"a_{{t}}_blocked"] = blocked(reqs)
out["a_buckets"] = np.array(buckets)
out["a_compiles"] = np.array([eng.compile_count, len(set(compiled)),
                              sorted(set(compiled)) == sorted(eng._programs)])
out["a_mesh"] = np.array(sorted(eng.stats()["mesh"].items()), dtype=object)
x = torch.from_numpy(rng.standard_normal((2, 16, 16)).astype(np.float32))
out["a_digc"] = digc(x, spec=DigcSpec(impl="ring", k=3, mesh=ring,
                                      axis_name="ring")).numpy()
out["a_digc_blocked"] = digc(x, k=3, impl="blocked").numpy()

# (b) parking through slot churn, then park_capacity=0
rng = np.random.default_rng(13)
mk = lambda t: VigRequest(uid=int(rng.integers(1 << 30)),
                          image=rng.standard_normal((16, 16, 3)).astype(
                              np.float32), tenant=t)
for cap in (8, 0):
    eng = VigServeEngine(cfg, params, digc_impl="ring", autotune=False,
                         buckets=(1, 2), mesh=ring, mesh_axis="ring",
                         park_capacity=cap, device="cpu")
    a1, b1 = mk("A"), mk("B")
    eng.submit(a1), eng.submit(b1)
    eng.step()
    c1 = mk("C")
    eng.submit(c1)
    eng.step()  # evicts the LRU tenant (and parks it when cap > 0)
    evicted = "A" if "A" not in eng.slot_tenant else "B"
    e2 = mk(evicted)
    eng.submit(e2)
    eng.step()
    hist = {{"A": [a1], "B": [b1]}}[evicted] + [e2]
    out[f"b{{cap}}_e2"] = e2.logits
    out[f"b{{cap}}_warm"] = replay(hist, ring, "ring")[-1]
    out[f"b{{cap}}_cold"] = replay([e2], ring, "ring")[0]
    slot = eng._tenant_slot[evicted]
    out[f"b{{cap}}_meta"] = np.array([
        eng.park_hits, len(eng.last_restores),
        eng.slot_row_steps()["stage0"][slot]])

# (c) bucket 3 on a (2, 2) ("ring", "data") mesh pads to width 4
mesh2 = make_mesh((2, 2), ("ring", "data"), device="cpu")
try:
    VigServeEngine(cfg, params, digc_impl="ring", autotune=False, mesh=mesh2,
                   mesh_axis="ring", mesh_batch_axis="data", buckets=(1, 3),
                   device="cpu")
    out["c_small"] = np.array("accepted")
except ValueError as e:
    out["c_small"] = np.array(str(e))
eng = VigServeEngine(cfg, params, digc_impl="ring", autotune=False,
                     mesh=mesh2, mesh_axis="ring", mesh_batch_axis="data",
                     buckets=(3,), device="cpu")
rng = np.random.default_rng(7)
reqs = [VigRequest(uid=i, image=rng.standard_normal((16, 16, 3)).astype(
    np.float32), tenant=t) for i, t in enumerate("ABC")]
for r in reqs:
    eng.submit(r)
out["c_meta"] = np.array([eng._tick_width(3), eng.step(), eng.last_bucket])
out["c_logits"] = np.stack([r.logits for r in reqs])
out["c_replay"] = np.concatenate([replay([r], mesh2, "ring") for r in reqs])
rank = torch.distributed.get_rank()
np.savez({d!r} + f"/rank{{rank}}.npz", **out)
print("RANK_OK", rank)
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve4")
    outs = testing.run_ranks(RANK_BODY.format(d=str(tmp)), 4, timeout=120)
    assert all("RANK_OK" in o for o in outs)
    return [dict(np.load(tmp / f"rank{r}.npz", allow_pickle=True))
            for r in range(4)]


def test_mesh_engine_ranks_serve_the_same_logits(ranks):
    for r in range(1, 4):
        for k, v in ranks[0].items():
            np.testing.assert_array_equal(ranks[r][k], v, err_msg=k)


def test_mesh_native_engine_bucketed_trace_matches_b1_replay(ranks):
    out = ranks[0]
    for t in "ABC":
        np.testing.assert_array_equal(out[f"a_{t}"], out[f"a_{t}_replay"])
        np.testing.assert_allclose(out[f"a_{t}"], out[f"a_{t}_blocked"],
                                   rtol=1e-5, atol=1e-5)
    for last, want in out["a_buckets"]:
        assert last == want
    count, distinct, same_keys = out["a_compiles"]
    assert count <= 2 and distinct == count and same_keys
    assert dict(out["a_mesh"]) == {"ring": 4}
    np.testing.assert_array_equal(out["a_digc"], out["a_digc_blocked"])


def test_mesh_native_engine_parking_survives_slot_churn(ranks):
    out = ranks[0]
    hits, restores, row_steps = out["b8_meta"]
    assert hits == 1 and restores >= 1
    assert row_steps == 2 * 2  # two requests through depth 2
    np.testing.assert_array_equal(out["b8_e2"], out["b8_warm"])
    # park_capacity=0: the evicted tenant returns cold, its counters
    # restarted (a ViG forward's co-nodes are its own features, so warm
    # and cold rows serve equal logits; the counters tell them apart)
    hits, _, row_steps = out["b0_meta"]
    assert hits == 0 and row_steps == 2
    np.testing.assert_array_equal(out["b0_e2"], out["b0_cold"])


def test_mesh_tick_padding_serves_nondividing_bucket(ranks):
    out = ranks[0]
    assert "smaller than" in str(out["c_small"])
    width, served, bucket = out["c_meta"]
    assert (width, served, bucket) == (4, 3, 3)
    np.testing.assert_allclose(out["c_logits"], out["c_replay"], rtol=1e-5,
                               atol=1e-5)
