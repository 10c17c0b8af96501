"""The example twins (``repro_torch/examples/``) against the JAX package's
``examples/`` scripts on the CPU: each JAX example's ``main`` and its
twin's ``main(["--device", "cpu"])`` on the same seeds, the twin's
parameters the JAX init converted through ``models/convert.py``.

Every printed number that is not a time is compared: ``quickstart``'s
edges, in-degree mean and max and ``fpga_cycles`` exactly and its
predictions equal (the twin holds the ``cuda`` tier to ``blocked`` by the
near-tie rule, where JAX asserts its three tiers bit for bit);
``serve_trace``'s whole report (ticks, deferrals, lanes, util, programs,
buckets, the retuned set) as text, under ``VirtualClock``; ``serve_lm``'s
tokens equal in fp32, as ``tests/test_torch_lm_serve.py`` holds the
engine; ``knn_attention_longctx`` at S = 256: the early rows' error
below 1e-5 on both sides and the mean cosine within 1e-3; ``nan_smoke``
runs, and its ``NanCheck`` mode raises on a planted NaN.
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.launch.api import get_api as jax_get_api  # noqa: E402
from repro.models import vig as jvig  # noqa: E402
from repro.models.module import init_params as jax_init_params  # noqa: E402
from repro_torch.examples import (  # noqa: E402
    knn_attention_longctx,
    nan_smoke,
    quickstart,
    serve_lm,
    serve_trace,
)
from repro_torch.models import convert  # noqa: E402

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
CPU = ["--device", "cpu"]


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _converted_vig(monkeypatch, twin):
    """Patch the twin's ``init_params`` to JAX's init of the same config
    (``PRNGKey(0)``, as the JAX examples draw it), converted."""
    def init(cfg, **kw):
        jcfg = jvig.VIG_VARIANTS[cfg.name].replace(
            **{f: getattr(cfg, f) for f in ("image_size", "patch", "embed_dims",
                                            "depths", "num_classes", "k",
                                            "digc_impl")})
        tree = jax.tree.map(np.asarray, jax_init_params(
            jvig.vig_param_spec(jcfg), jax.random.PRNGKey(0)))
        return convert.params_from_numpy(cfg, tree, device="cpu")

    monkeypatch.setattr(twin, "init_params", init)


def _numbers(text):
    return [float(x) for x in re.findall(r"-?\d+\.?\d*(?:e[-+]\d+)?", text)]


def test_quickstart_matches_jax(monkeypatch, capsys):
    _jax_example("quickstart").main()
    want = capsys.readouterr().out
    _converted_vig(monkeypatch, quickstart)
    out = quickstart.main(CPU)
    got = capsys.readouterr().out
    line = lambda text, key: next(l for l in text.splitlines() if key in l)  # noqa: E731
    for key in ("edges=", "cycle model", "ViG forward", "predictions"):
        assert _numbers(line(got, key)) == _numbers(line(want, key)), key
    assert "agree across reference/blocked: True" in got
    assert out["edges"] == 1568 and out["swaps"] >= 0


def test_serve_trace_matches_jax(monkeypatch, capsys):
    _jax_example("serve_trace").main([])
    want = capsys.readouterr().out
    _converted_vig(monkeypatch, serve_trace)
    exact, sched, tuned = serve_trace.main(CPU)
    got = capsys.readouterr().out
    assert got == want
    assert tuned == sched.buckets and exact.buckets is None


def test_serve_lm_tokens_match_jax(monkeypatch, capsys):
    jex = _jax_example("serve_lm")
    fp32 = lambda get: (lambda arch: get(arch).replace(dtype="float32"))  # noqa: E731
    monkeypatch.setattr(jex, "get_smoke", fp32(jex.get_smoke))
    monkeypatch.setattr(serve_lm, "get_smoke", fp32(serve_lm.get_smoke))
    jex.main([])
    want = capsys.readouterr().out
    jcfg = jex.get_smoke("olmo-1b")
    tree = jax.tree.map(np.asarray, jax_init_params(
        jax_get_api(jcfg).param_spec(), jax.random.PRNGKey(0)))
    monkeypatch.setattr(serve_lm, "init_params", lambda spec, **kw:
                        convert.lm_params_from_numpy(serve_lm.get_smoke("olmo-1b"),
                                                     tree, device="cpu"))
    finished = serve_lm.main(CPU)
    got = capsys.readouterr().out
    reqs = lambda text: [l for l in text.splitlines() if l.startswith("req ")]  # noqa: E731
    assert len(reqs(want)) == 6 and reqs(got) == reqs(want)
    assert sum(len(r.out_tokens) for r in finished) == 72


def test_knn_attention_longctx_matches_jax(capsys):
    _jax_example("knn_attention_longctx").main(["--seq", "256"])
    want = capsys.readouterr().out
    out = knn_attention_longctx.main(["--seq", "256", *CPU])
    got = capsys.readouterr().out
    j_early = _numbers(next(l for l in want.splitlines() if "early rows" in l))[-1]
    j_cos = _numbers(next(l for l in want.splitlines() if "cosine" in l))[-1]
    assert j_early < 1e-5 and out["early"] < 1e-5
    assert abs(out["cos"] - j_cos) <= 1e-3, (out["cos"], j_cos)
    assert "CUDA events" not in got and "host clock" in got


def test_nan_smoke_runs_and_its_mode_raises_on_a_planted_nan(capsys):
    _jax_example("nan_smoke").main()
    want = capsys.readouterr().out
    nan_smoke.main(CPU)
    got = capsys.readouterr().out
    assert "NAN_SMOKE_OK" in want and "NAN_SMOKE_OK" in got
    for key in ("reference DIGC: idx (2, 64, 4)", "ViG tick 1: logits (2, 3)",
                "ViG tick 2: logits (2, 3)"):
        assert key in want and key in got, key
    with nan_smoke.NanCheck():
        buf = torch.empty(8)  # allocation: never screened
        buf.fill_(1.0)
        x = torch.zeros(3)
        with pytest.raises(FloatingPointError, match="div"):
            x / x
        with pytest.raises(FloatingPointError):
            torch.log(x - 1.0)
