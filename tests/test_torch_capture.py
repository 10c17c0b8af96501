"""The engine's bucket programs (``mode``) and what CUDA-graph capture
needs from the layers below it.

On the CPU: ``mode`` validation as in JAX; ``mode="eager"`` refusing the
request path; the launch tally that a replay adds to the kernel counters
(with a fake graph); and the reuse gate's read-free branch, which a
captured graph takes, bit for bit its host-read branch over a trace that
mixes reused, rebuilt and cold rows, for ``layer``, ``tick`` (its first
and later calls) and ``overlap``.

Marked ``gpu`` (skipped without a card; run with
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_capture.py``):
captured against eager bit for bit, launch counts equal to the eager
engine's, ``_degrade`` dropping the graphs, and a launch error during
capture raising out of ``step()`` instead of descending the ladder.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve.engine import VigServeEngine as JaxEngine  # noqa: E402
from repro.models import vig as jvig  # noqa: E402
from repro_torch import kernels, testing  # noqa: E402
from repro_torch.core import DigcSpec  # noqa: E402
from repro_torch.core.faults import FaultInfo  # noqa: E402
from repro_torch.core.state import FIELDS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import convert, vig  # noqa: E402
from repro_torch.serve import engine as engine_mod  # noqa: E402
from repro_torch.serve.engine import VigRequest, VigServeEngine  # noqa: E402

digc_mod = importlib.import_module("repro_torch.core.digc")

CPU = "cpu"
KW = dict(image_size=16, patch=4, embed_dims=(16,), depths=(2,),
          num_classes=3, k=3)
TAU = 0.002


def _model(device=CPU):
    cfg = vig.VIG_VARIANTS["vig_ti_iso"].replace(**KW)
    params = convert.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                 device=device)
    return cfg, params


def _frames(seed: int, n: int, sigma) -> list:
    """A tenant's frames: a seeded image plus N(0, sigma^2) pixel noise a
    frame; sigma None gives a new image every frame."""
    rng = np.random.default_rng(seed)
    if sigma is None:
        return [testing.images(seed * 100 + t, 1, 16)[0] for t in range(n)]
    out = [testing.images(seed, 1, 16)[0]]
    for _ in range(n - 1):
        out.append((out[-1] + sigma * rng.standard_normal(out[-1].shape))
                   .astype(np.float32))
    return out


# Ticks of tenants on 4 slots: video tenants a-c reuse their graphs,
# "n" sends a new image every frame (rebuilds), "e" arrives late and
# evicts the least recently used tenant (cold rows, parking, restores).
TRACE = [["a", "b", "c", "n"], ["a", "b", "n"], ["a", "c", "n"],
         ["e", "n", "b"], ["a", "n"], ["a", "b", "c", "n"], ["e"],
         ["a", "b", "c", "n"]]


def _requests():
    frames = {t: _frames(i + 1, 8, None if t == "n" else 0.001)
              for i, t in enumerate("abcen")}
    seen: dict = {}
    ticks = []
    for base, tick in enumerate(TRACE):
        reqs = []
        for t in tick:
            i = seen.get(t, 0)
            seen[t] = i + 1
            reqs.append((10 * base + len(reqs), t, frames[t][i]))
        ticks.append(reqs)
    return ticks


def _serve(eng) -> list:
    out = []
    for reqs in _requests():
        mine = [VigRequest(uid, img, tenant=t) for uid, t, img in reqs]
        for r in mine:
            eng.submit(r)
        eng.step()
        out += mine
    return out


# -- mode -----------------------------------------------------------------


def test_mode_is_validated_like_jax():
    cfg, params = _model()
    jcfg = jvig.VIG_VARIANTS["vig_ti_iso"].replace(**KW)
    for bad in ("graph", "JIT", None):
        with pytest.raises(ValueError, match="mode must be 'jit' or 'eager'"):
            VigServeEngine(cfg, params, mode=bad, device=CPU)
        with pytest.raises(ValueError, match="mode must be 'jit' or 'eager'"):
            JaxEngine(jcfg, {}, mode=bad)
    assert VigServeEngine(cfg, params, device=CPU).stats()["mode"] == "jit"


def test_eager_mode_refuses_the_request_path():
    cfg, params = _model()
    eng = VigServeEngine(cfg, params, mode="eager", autotune=False,
                         digc_impl="blocked", device=CPU)
    img = testing.images(0, 1, 16)
    eng.submit(VigRequest(0, img[0], tenant="A"))
    with pytest.raises(RuntimeError, match="mode='jit'"):
        eng.step()
    assert eng.infer(img).shape == (1, 3)  # the direct path runs eagerly


def test_cpu_programs_run_eagerly_and_count_when_built():
    cfg, params = _model()
    built = []
    eng = VigServeEngine(cfg, params, autotune=False, digc_impl="blocked",
                         buckets=(1, 2, 4), on_compile=built.append,
                         device=CPU)
    _serve(eng)
    assert not eng._captures() and eng._captured == {}
    assert eng.compile_count == len(built) == len(eng._programs) == 3


def test_tuning_failure_raises_out_of_step_not_into_the_ladder(monkeypatch):
    """The tuner builds and times the kernels: when it fails, ``step()``
    raises, with no retry and no step down the ladder (which would serve
    the plain tier in the kernel's place)."""
    cfg, params = _model()

    def failing(self, *args, **kwargs):
        raise RuntimeError("nvcc: kernel build failed")

    monkeypatch.setattr(engine_mod.DigcTuner, "tune_bucket_schedules", failing)
    eng = VigServeEngine(cfg, params, digc_impl="blocked", autotune=True,
                         buckets=(1,), device=CPU)
    eng.submit(VigRequest(0, testing.images(0, 1, 16)[0], tenant="A"))
    with pytest.raises(RuntimeError, match="kernel build failed"):
        eng.step()
    st = eng.stats()
    assert st["fallback_level"] == 0 and st["retries"] == 0 and not eng.fault_log
    assert eng._programs == {}


# -- launch tallies -------------------------------------------------------


def test_uncounted_launches_returns_the_tally_and_restores_counts():
    kernels.reset_launch_counts()
    kernels.add_launch_counts({"digc_topk": 5, "mrconv": 2})
    with kernels.uncounted_launches() as tally:
        kernels.digc_topk.digc_topk_launches += 12
        kernels.digc_topk.variant_launches["legacy"] += 12
        kernels.mrconv.mrconv_launches += 12
    assert tally == {"digc_topk": 12, "digc_topk.legacy": 12, "mrconv": 12}
    counts = kernels.launch_counts()
    assert (counts["digc_topk"], counts["mrconv"],
            counts["digc_topk.legacy"]) == (5, 2, 0)
    kernels.reset_launch_counts()


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replay_fills_static_inputs_and_adds_the_tally():
    cfg, _ = _model()
    spec = DigcSpec(impl="blocked", k=3, reuse="tick", drift_tau=TAU)
    static = vig.init_vig_state(cfg, 2, spec, per_slot=True, device=CPU)
    src = vig.init_vig_state(cfg, 2, spec, per_slot=True, device=CPU)
    e = src.entries["stage0"]
    src = type(src)(entries={"stage0": type(e)(**{
        f: None if getattr(e, f) is None else
        torch.full_like(getattr(e, f), i + 1)
        for i, f in enumerate(FIELDS)})})
    graph = _FakeGraph()
    logits = torch.zeros(2, 3)
    cap = engine_mod._Captured(graph=graph, images=torch.zeros(2, 16, 16, 3),
                               state=static, logits=logits, new_state=static,
                               tally={"digc_topk": 2, "mrconv": 2})
    kernels.reset_launch_counts()
    for _ in range(3):
        out_logits, out_state = cap.replay(src)
    assert graph.replays == 3 and out_logits is logits
    counts = kernels.launch_counts()
    assert counts["digc_topk"] == counts["mrconv"] == 6
    for f in FIELDS:
        want = getattr(src.entries["stage0"], f)
        if want is not None:
            assert torch.equal(getattr(static.entries["stage0"], f), want), f
    kernels.reset_launch_counts()


# -- the read-free gate ---------------------------------------------------


@pytest.mark.parametrize("policy", ["layer", "tick", "overlap"])
def test_read_free_gate_matches_host_read_gate(policy, monkeypatch):
    """Forcing the branch a captured graph takes (build every row, keep
    the reused rows' cached graph by a per-row select) serves the same
    logits, bit for bit, and leaves the same state, with no host read."""
    cfg, params = _model()
    spec = DigcSpec(impl="blocked", k=3, reuse=policy, drift_tau=TAU,
                    max_stale=3)

    def engine():
        return VigServeEngine(cfg, params, digc_impl=spec, autotune=False,
                              buckets=(1, 2, 4), device=CPU)

    read = engine()
    want = _serve(read)
    monkeypatch.setattr(digc_mod, "capturing", lambda t: True)
    free = engine()
    got = _serve(free)
    for r, w in zip(got, want):
        assert np.array_equal(r.logits, w.logits), r.uid
    a, b = read._slot_state.entries["stage0"], free._slot_state.entries["stage0"]
    for f in FIELDS:
        if getattr(a, f) is not None:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    s, fs = read.stats(), free.stats()
    for key in ("graph_reuses", "graph_rebuilds", "park_hits",
                "slot_row_steps"):
        assert s[key] == fs[key], key
    assert fs["gate_reads"] == 0 and s["gate_reads"] > 0
    assert s["graph_rebuilds"] > 0 and s["park_hits"] > 0
    if policy == "tick":  # the trace mixes reused and rebuilt rows
        assert s["graph_reuses"] > 0


# -- on the card ----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


class _Eager(VigServeEngine):
    """The same engine with its bucket programs run eagerly on the card."""

    def _captures(self):
        return False


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["cuda", "tick", "overlap"])
def test_captured_equals_eager_bitwise_on_card(cuda, impl):
    cfg, params = _model(cuda)
    spec = (DigcSpec(impl="cuda", k=3) if impl == "cuda" else
            DigcSpec(impl="blocked", k=3, reuse=impl, drift_tau=TAU,
                     max_stale=3))

    def serve(cls):
        eng = cls(cfg, params, digc_impl=spec, autotune=False,
                  buckets=(1, 2, 4), device=cuda)
        kernels.reset_launch_counts()
        reqs = _serve(eng)
        return eng, reqs, kernels.launch_counts()

    eager, want, eager_counts = serve(_Eager)
    graph, got, graph_counts = serve(VigServeEngine)
    for r, w in zip(got, want):
        assert np.array_equal(r.logits, w.logits), r.uid
    assert graph.compile_count == len(graph._captured) == 3
    assert graph_counts == eager_counts
    assert graph.stats()["fallback_level"] == 0 and not graph.fault_log
    if impl != "cuda":
        # only each bucket's first (eager) tick reads the gate
        assert 0 < graph.gate_reads < eager.gate_reads


@pytest.mark.gpu
def test_degrade_drops_graphs_and_recaptures(cuda):
    cfg, params = _model(cuda)
    eng = VigServeEngine(cfg, params, digc_impl="cuda", autotune=False,
                         buckets=(4,), device=cuda)
    _serve(eng)
    assert list(eng._captured) == [4] and eng.compile_count == 1
    assert eng._degrade(FaultInfo(kind="test", site="program.build"))
    assert eng._captured == {} and eng._programs == {}
    _serve(eng)
    assert eng.compile_count == 2 and eng.stats()["fallback_impl"] == "blocked"


@pytest.mark.gpu
def test_capture_error_raises_out_of_step(cuda, monkeypatch):
    """A kernel that fails while the graph is captured is not a build
    failure: ``step()`` raises and the ladder stays at level 0."""
    cfg, params = _model(cuda)
    real = ops.mrconv_cuda

    def failing(*args):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("mrconv kernel launch failed")
        return real(*args)

    monkeypatch.setattr(ops, "mrconv_cuda", failing)
    eng = VigServeEngine(cfg, params, digc_impl="cuda", autotune=False,
                         buckets=(1,), device=cuda)
    eng.submit(VigRequest(0, testing.images(0, 1, 16)[0], tenant="A"))
    with pytest.raises(RuntimeError, match="launch failed"):
        eng.step()
    assert eng.fallback_level == 0 and not eng.fault_log


@pytest.mark.gpu
def test_kernel_build_failure_in_tuning_raises_out_of_step(cuda, monkeypatch):
    """The default engine (``blocked`` tier, ``autotune=True``) tunes on
    its first tick, timing the ``cuda`` kernel on the card: a kernel that
    fails to build there raises out of ``step()`` at ladder level 0."""
    from repro_torch.kernels import _build

    def failing():
        raise _build.KernelBuildError("nvcc compile failed")

    monkeypatch.setattr(_build, "load", failing)
    cfg, params = _model(cuda)
    eng = VigServeEngine(cfg, params, digc_impl="blocked", autotune=True,
                         buckets=(1,), device=cuda)
    eng.submit(VigRequest(0, testing.images(0, 1, 16)[0], tenant="A"))
    with pytest.raises(_build.KernelBuildError, match="compile failed"):
        eng.step()
    assert eng.fallback_level == 0 and not eng.fault_log and eng.retries == 0
