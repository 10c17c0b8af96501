"""The port's tuner (``repro_torch.core.tuner``) on the CPU: the cases of
tests/test_tuner.py that this slice ports, plus equality with the JAX
package where both compute the same function (workload keys, the
bucket-set optimizer, the drift-gate scaling, the tuning probes)."""

import importlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _hypothesis_compat import HAVE_HYPOTHESIS, given, settings, st  # noqa: E402

from repro.core import builder as jbuilder  # noqa: E402
from repro.core import tuner as jtuner  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.core import DigcSpec, digc  # noqa: E402
from repro_torch.core.perfmodel import kernel_tile_defaults  # noqa: E402
from repro_torch.core.tuner import (  # noqa: E402
    DigcTuner,
    TileConfig,
    TuneResult,
    VigSchedule,
    autotune_spec,
    bucket_set_key,
    host_key,
    matches_oracle,
    optimal_bucket_set,
    pick_best,
    scale_tau,
    tune_reuse,
    workload_key,
)

CPU = "cpu"


def _rand(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _tuner(path=None, **kw):
    return DigcTuner(path, device=CPU, **kw)


@pytest.mark.parametrize("args,kw", [
    ((2, 196, 196, 192, 18), {}), ((2, 196, 196, 192, 9), {}),
    ((2, 196, 196, 192, 18), dict(causal=True)),
    ((1, 3136, 196, 48, 9), dict(has_pos=True)),
    ((4, 64, 64, 8, 4), dict(causal=True, has_pos=True, mesh_shape=(4,))),
])
def test_workload_and_bucket_keys_equal_jax(args, kw):
    assert workload_key(*args, **kw) == jtuner.workload_key(*args, **kw)
    assert bucket_set_key(8, (224, 64), 3) == jtuner.bucket_set_key(
        8, (224, 64), 3)


def test_workload_key_distinguishes_workloads():
    a = workload_key(2, 196, 196, 192, 18)
    b = workload_key(2, 196, 196, 192, 9)
    c = workload_key(2, 196, 196, 192, 18, causal=True)
    assert len({a, b, c}) == 3


def test_host_key_carries_backend_platform_torch_cuda_and_device():
    import platform as _platform

    hk = host_key("cpu")
    assert hk.startswith("cpu|")
    assert _platform.machine() in hk
    assert f"torch-{torch.__version__}" in hk
    assert f"cuda-{torch.version.cuda}" in hk
    assert host_key("cuda") != hk
    assert _tuner().host == hk


def test_candidates_exact_only_by_default_and_include_kernel_configs():
    t = _tuner()
    cands = t.candidates(1024, 1024)
    engine = [c for c in cands if c.impl == "blocked"]
    assert engine and all(c.merge in ("select", "topk") for c in engine)
    assert any(c.merge == "packed" for c in t.candidates(
        1024, 1024, allow_approx=True) if c.impl == "blocked")
    kern = [c for c in t.candidates(3136, 3136, d=96, kd=9)
            if c.impl == "cuda"]
    assert {c.kernel_merge for c in kern} == {"bitonic", "legacy"}
    assert kernel_tile_defaults(3136, 3136, 96, 9) in {
        (c.block_n, c.block_m) for c in kern}
    assert any(c.impl == "cuda" for c in t.candidates(1024, 1024))


@pytest.mark.parametrize("cfg,want", [
    (TileConfig(128, 256, "select", True),
     dict(impl="blocked", block_n=128, block_m=256, merge="select",
          fuse_norms=True, kernel_merge=None)),
    (TileConfig(16, 256, "kernel", False, impl="cuda", kernel_merge="legacy"),
     dict(impl="cuda", block_n=16, block_m=256, merge=None, fuse_norms=None,
          kernel_merge="legacy")),
])
def test_tile_config_apply_fills_spec(cfg, want):
    s = cfg.apply(DigcSpec(impl="blocked", k=5, dilation=2))
    assert {f: getattr(s, f) for f in want} == want
    assert (s.k, s.dilation) == (5, 2)
    digc(torch.zeros(2, 40, 4), spec=s)  # the builder accepts the knobs


def test_tune_measures_persists_and_caches(tmp_path):
    x = _rand(np.random.default_rng(0), 2, 96, 8)
    path = tmp_path / "tune.json"
    spec = DigcSpec(impl="blocked", k=4)
    tuner = _tuner(path, measure_iters=1, max_measure=2)
    tuned, res = tuner.tune(x, spec=spec)
    assert res.source == "measured" and res.exact_match
    assert tuned.block_m is not None and tuned.merge in ("select", "topk")
    (entry,) = tuner.log
    assert 2 <= len(entry["measured"]) <= 3  # the oracle and the top two
    assert [c for c, _ in entry["ranked"]] == tuner.rank(
        tuner.candidates(96, 96, d=8, kd=4), b=2, n=96, m=96, d=8, kd=4)
    np.testing.assert_array_equal(digc(x, k=4, impl="reference").numpy(),
                                  digc(x, spec=tuned).numpy())
    data = json.loads(path.read_text())
    assert data["schema"] == 3 and list(data["hosts"]) == [host_key("cpu")]
    assert len(data["hosts"][host_key("cpu")]["schedules"]) == 1
    tuned2, res2 = _tuner(path).tune(x, spec=spec)
    assert res2.source == "cached"
    assert (tuned2.block_n, tuned2.block_m, tuned2.merge) == (
        tuned.block_n, tuned.block_m, tuned.merge)


def _oracle_rows():
    """Two rows of an oracle's (idx, dist): row 0 has a tie at positions
    1-2 and a tie between its last entry and a neighbour it cut."""
    idx = np.array([[[7, 3, 9, 4], [0, 1, 2, 5]]], np.int32)
    dist = np.array([[[1.0, 2.0, 2.0, 5.0], [0.5, 1.5, 3.0, 4.0]]],
                    np.float32)
    return idx, dist


def _planted(case):
    idx, dist = (a.copy() for a in _oracle_rows())
    if case == "near_tie_swap":
        idx[0, 0, [1, 2]] = idx[0, 0, [2, 1]]
    elif case == "cut_tie":  # index 11 sits at distance 5.0 too
        idx[0, 0, 3] = 11
    elif case == "wrong_swap":  # 3 and 4 lie 3.0 apart in the oracle's row
        idx[0, 0, [1, 3]] = idx[0, 0, [3, 1]]
    elif case == "wrong_absent":  # 11 is no neighbour at distance 0.5
        idx[0, 1, 0] = 11
    elif case == "repeated":
        idx[0, 1, 3] = idx[0, 1, 2]
    elif case == "far_distance":
        dist[0, 1, 2] += 0.1
    return torch.from_numpy(idx), torch.from_numpy(dist)


@pytest.mark.parametrize("case,want", [
    ("equal", True), ("near_tie_swap", True), ("cut_tie", True),
    ("wrong_swap", False), ("wrong_absent", False), ("repeated", False),
    ("far_distance", False),
])
def test_candidate_gate_tolerates_only_near_ties(case, want):
    """A candidate's indices must equal the oracle's except at the
    oracle's own fp32 near-ties; equal distances do not excuse a wrong or
    repeated index."""
    oracle = tuple(torch.from_numpy(a) for a in _oracle_rows())
    assert matches_oracle(_planted(case), oracle, scale=1.0) is want


@pytest.mark.parametrize("dilation", [1, 2])
@pytest.mark.parametrize("plant,chosen", [("wrong", False), ("tie", True)])
def test_tune_rejects_planted_wrong_candidates(monkeypatch, plant, chosen,
                                               dilation):
    """On exactly tied inputs, kernel candidates that return the oracle's
    distances with indices swapped inside tied pairs stay eligible, also
    where dilation keeps one member of a pair (the gate checks the full
    top-kd lists); with the first and last neighbours swapped they are
    rejected, although they are measured and their distances agree."""
    digc_mod = importlib.import_module("repro_torch.core.digc")
    real = digc_mod.digc
    x, _ = testing.tied_inputs(5, 2, 48, 48, 6)
    x = torch.from_numpy(x)
    y = x.clone()
    y[:, 1::2] = y[:, 0:47:2]  # each odd co-node repeats the one before

    def planted(*args, spec, **kw):
        idx, dist = real(*args, spec=spec, **kw)
        if spec.impl != "cuda":
            return idx, dist
        if plant == "wrong":
            idx = idx.clone()
            idx[..., [0, -1]] = idx[..., [-1, 0]]
        else:  # the other member of each index's tied pair
            idx = idx ^ 1
        return idx, dist

    monkeypatch.setattr(digc_mod, "digc", planted)
    tuner = DigcTuner(device=CPU, backend="cuda", measure_iters=1)
    _, res = tuner.tune(x, y, spec=DigcSpec(impl="blocked", k=4,
                                            dilation=dilation))
    measured = tuner.log[0]["measured"]
    kernel = [r for r in measured if r.config.impl == "cuda"]
    assert kernel and all(r.exact_match is chosen for r in kernel)
    if not chosen:
        assert res.config.impl == "blocked"


def _result(merge, us, device_us=None):
    return TuneResult(TileConfig(16, 64, "kernel", False, impl="cuda",
                                 kernel_merge=merge), us, True, "measured",
                      device_us)


@pytest.mark.parametrize("results,want", [
    # No device times (the CPU): the fastest call, as the JAX tuner picks.
    ([("bitonic", 65.0), ("legacy", 63.9)], "legacy"),
    # Host-paced alike: the least device time decides.
    ([("bitonic", 65.0, 40.0), ("legacy", 63.9, 52.0)], "bitonic"),
    # Beyond 10% of the fastest, device time does not enter.
    ([("bitonic", 80.0, 40.0), ("legacy", 63.9, 52.0)], "legacy"),
])
def test_pick_best_breaks_host_paced_ties_by_device_time(results, want):
    assert pick_best([_result(*r) for r in results]).config.kernel_merge == want


def test_kernel_winner_persists_and_applies(tmp_path):
    path = tmp_path / "tune.json"
    tuner = _tuner(path)
    key = workload_key(2, 3136, 3136, 96, 18)
    cfg = TileConfig(16, 256, "kernel", False, impl="cuda",
                     kernel_merge="legacy")
    tuner.entries[key] = TuneResult(cfg, 123.0, True, "measured",
                                    41.5).as_dict()
    tuner.save()
    cached = _tuner(path).lookup(key)
    assert cached is not None and cached.source == "cached"
    assert cached.config == cfg and cached.device_us == 41.5
    s = cached.config.apply(DigcSpec(impl="blocked", k=9, dilation=2))
    assert (s.impl, s.kernel_merge, s.block_n, s.block_m) == (
        "cuda", "legacy", 16, 256)
    assert s.merge is None and s.fuse_norms is None


def test_tune_cache_not_shared_across_hosts(tmp_path):
    x = _rand(np.random.default_rng(3), 2, 64, 8)
    path = tmp_path / "tune.json"
    spec = DigcSpec(impl="blocked", k=4)
    _tuner(path, measure_iters=1, max_measure=1).tune(x, spec=spec)
    other = _tuner(path, measure_iters=1, max_measure=1)
    other.host = "cuda|linux-x86_64|torch-9.9|cuda-12.8|NVIDIA H100"
    slot = other._hosts.setdefault(other.host,
                                   {"schedules": {}, "bucket_sets": {}})
    other.entries = slot["schedules"]
    other.bucket_sets = slot["bucket_sets"]
    _, res = other.tune(x, spec=spec)
    assert res.source == "measured"
    assert len(json.loads(path.read_text())["hosts"]) == 2


@pytest.mark.parametrize("schema", [1, 2])
def test_old_cache_schemas(tmp_path, schema):
    """Schema 1 (flat, no host identity) is dropped; schema 2 (hosts
    mapping straight to schedules) migrates losslessly to schema 3."""
    path = tmp_path / "tune.json"
    key = workload_key(2, 64, 64, 8, 4)
    entry = {"block_n": None, "block_m": 64, "merge": "select",
             "fuse_norms": False, "impl": "blocked", "kernel_merge": None,
             "us_per_call": 1.0, "exact_match": True, "source": "measured"}
    if schema == 1:
        path.write_text(json.dumps({"schema": 1, "backend": "cpu",
                                    "entries": {"cpu:" + key: entry}}))
        tuner = _tuner(path)
        assert tuner.entries == {} and tuner.lookup(key) is None
        return
    path.write_text(json.dumps({"schema": 2,
                                "hosts": {host_key("cpu"): {key: entry}}}))
    tuner = _tuner(path)
    assert tuner.lookup(key).source == "cached"
    assert tuner.bucket_sets == {}
    tuner.save()
    data = json.loads(path.read_text())
    assert data["schema"] == 3
    assert data["hosts"][host_key("cpu")]["schedules"][key]["block_m"] == 64
    assert _tuner(path).lookup(key).config.block_m == 64


def test_tune_schedule_per_stage(tmp_path):
    path = tmp_path / "tune.json"
    tuner = _tuner(path, measure_iters=1, max_measure=1)
    workloads = [
        {"stage": 0, "N": 64, "M": 16, "D": 8, "k": 3, "dilation": 1},
        {"stage": 1, "N": 16, "M": 16, "D": 8, "k": 3, "dilation": 1},
    ]
    sched, results = tuner.tune_schedule(
        workloads, spec=DigcSpec(impl="blocked", k=3), batch=2)
    assert len(sched.stages) == 2
    assert all(r.source == "measured" for r in results)
    assert sched.spec_for(0) == sched.stages[0]
    assert sched.spec_for(5) == sched.stages[1]
    data = json.loads(path.read_text())
    assert len(data["hosts"][host_key("cpu")]["schedules"]) == 2
    sched2, results2 = _tuner(path).tune_schedule(
        workloads, spec=DigcSpec(impl="blocked", k=3), batch=2)
    assert all(r.source == "cached" for r in results2)
    assert sched2.describe() == sched.describe()


def test_tune_schedule_probes_are_the_jax_packages(monkeypatch):
    """Both packages draw the probes from one numpy generator in the same
    order: x, then y where M != N, stage by stage."""
    seen = []
    tuner = _tuner()
    monkeypatch.setattr(tuner, "tune", lambda x, y=None, *, spec, **kw: (
        seen.append((x.numpy(), None if y is None else y.numpy())) or
        (spec, TuneResult(TileConfig(None, 0, "n/a"), 0.0, True, "prior"))))
    workloads = [{"N": 16, "M": 4, "D": 3, "k": 2, "dilation": 1},
                 {"N": 4, "M": 4, "D": 5, "k": 2, "dilation": 1}]
    tuner.tune_schedule(workloads, spec=DigcSpec(k=2), batch=2, rng_seed=7)
    rng = np.random.default_rng(7)
    want = [(rng.standard_normal((2, 16, 3)), rng.standard_normal((2, 4, 3))),
            (rng.standard_normal((2, 4, 5)), None)]
    for (x, y), (wx, wy) in zip(seen, want):
        np.testing.assert_array_equal(x, wx.astype(np.float32))
        assert (y is None) == (wy is None)
        if y is not None:
            np.testing.assert_array_equal(y, wy.astype(np.float32))


def test_non_blocked_specs_pass_through():
    sched, results = _tuner().tune_schedule(
        [{"stage": 0, "N": 16, "M": 16, "D": 4, "k": 2, "dilation": 1}],
        spec=DigcSpec(impl="reference", k=2))
    assert isinstance(sched, VigSchedule)
    assert results[0].source == "prior"
    assert sched.spec_for(0).impl == "reference"
    spec = DigcSpec(impl="cuda", k=3)
    tuned, res = autotune_spec(torch.zeros(40, 6), spec=spec)
    assert tuned is spec and res.source == "prior"


def test_reuse_search_not_ported_yet():
    """Named for the stub it once pinned; the reuse search is ported.
    ``with_reuse`` overlays the stateful stages and strips with None, as
    JAX's does; an empty trace admits the first candidate at recall 1,
    as JAX's replay does."""
    sched = VigSchedule(stages=(DigcSpec(impl="blocked", k=3),))
    jsched = jtuner.VigSchedule(stages=(jbuilder.DigcSpec(impl="blocked", k=3),))
    out = sched.with_reuse("tick", drift_tau=0.1)
    jout = jsched.with_reuse("tick", drift_tau=0.1)
    assert out.describe() == jout.describe()
    assert out.stages[0].drift_tau == jout.stages[0].drift_tau == 0.1
    assert out.with_reuse(None) == sched
    tuned, results = tune_reuse([], spec=DigcSpec(k=3))
    jtuned, jresults = jtuner.tune_reuse([], spec=jbuilder.DigcSpec(k=3))
    assert [r.as_dict() for r in results] == [r.as_dict() for r in jresults]
    assert (tuned.reuse, tuned.drift_tau) == (jtuned.reuse, jtuned.drift_tau)
    with pytest.raises(ValueError, match="empty"):
        VigSchedule(stages=()).spec_for(0)


@pytest.mark.parametrize("hist,kw,want", [
    ({1: 10, 8: 1}, dict(slots=8, max_programs=2), (1, 8)),
    ({1: 10, 8: 1}, dict(slots=8, max_programs=1), (8,)),
    ({1: 5, 3: 4, 6: 2}, dict(slots=8, max_programs=4), (1, 3, 6, 8)),
    ({}, dict(slots=8), (8,)),
    ({8: 5}, dict(slots=8, max_programs=4), (8,)),
    ({224: {1: 10, 4: 10}, 448: {2: 10}},
     dict(slots=4, max_programs=2, costs={224: 1, 448: 1000}), (2, 4)),
])
def test_optimal_bucket_set_cases(hist, kw, want):
    assert optimal_bucket_set(hist, **kw) == want
    assert jtuner.optimal_bucket_set(hist, **kw) == want


def test_optimal_bucket_set_rejects_out_of_range():
    with pytest.raises(ValueError, match="outside"):
        optimal_bucket_set({9: 1}, slots=8)


@settings(deadline=None, max_examples=40)
@given(hist=st.dictionaries(st.integers(1, 8), st.integers(1, 50),
                            max_size=8),
       cap=st.integers(1, 5))
def test_optimal_bucket_set_equals_jax(hist, cap):
    if not HAVE_HYPOTHESIS:  # pragma: no cover - shim path
        pytest.skip("hypothesis not installed")
    sized = {224: hist, 448: {k: v + 1 for k, v in hist.items()}}
    for h, costs in ((hist, None), (sized, {224: 196, 448: 784})):
        assert optimal_bucket_set(h, slots=8, max_programs=cap,
                                  costs=costs) == \
            jtuner.optimal_bucket_set(h, slots=8, max_programs=cap,
                                      costs=costs)


@settings(deadline=None, max_examples=40)
@given(tau=st.floats(0.0, 1.0), n_ref=st.integers(1, 20000),
       n=st.integers(0, 20000))
def test_scale_tau_equals_jax(tau, n_ref, n):
    if not HAVE_HYPOTHESIS:  # pragma: no cover - shim path
        pytest.skip("hypothesis not installed")
    assert scale_tau(tau, n_ref, n) == jtuner.scale_tau(tau, n_ref, n)


def test_tune_bucket_set_persists_per_shape(tmp_path):
    path = tmp_path / "tune.json"
    hist = {32: {1: 10, 2: 4, 8: 1}}
    got = _tuner(path).tune_bucket_set(hist, slots=8, max_programs=3)
    assert got == optimal_bucket_set(hist, slots=8, max_programs=3)
    fresh = _tuner(path)
    assert fresh.lookup_bucket_set(slots=8, sizes=(32,), max_programs=3) == got
    assert fresh.lookup_bucket_set(slots=4, sizes=(32,),
                                   max_programs=3) is None
    other = {32: {7: 100}}
    assert fresh.tune_bucket_set(other, slots=8, max_programs=3,
                                 sizes=(32,)) == got
    assert fresh.tune_bucket_set(other, slots=8, max_programs=3, sizes=(32,),
                                 force=True) == (7, 8)
    entry = json.loads(path.read_text())["hosts"][host_key("cpu")][
        "bucket_sets"][bucket_set_key(8, (32,), 3)]
    assert entry["hist"] == {"32:7": 100}


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DigcTuner()
