"""A bf16 generating model enters the benchmark with new files only.

The family below is defined here, not under ``families/``, and handed
to the harness by ``monkeypatch`` on ``harness.load_family``: it serves
OLMo's smoke configuration (``repro_torch.configs.olmo_1b.SMOKE``) in
bf16 through the port's ``ServeEngine`` on the CPU, greedy, and keeps
the family contract of ``families/__init__.py``:

- an answer is a row for every token the program emitted: the token
  the sequence went on with, the token judged there (for the program
  the same one), the logit the program gave it and its row's
  log-sum-exp, read by wrapping the engine's decode call;
- ``reference`` returns a teacher: plain fp32 (TF32 off), teacher-forced
  on each answer's own tokens, since near-tied top logits of random
  weights flip under rounding and a continuation of its own would part
  from the program's;
- its control is the same arithmetic one step below bf16: every matrix
  product's operands rounded to fp8 e4m3 (per-tensor scale, fp32
  accumulation), teacher-forced on the program's prompts and tokens,
  its own first token judged at each position.

``harness.run_cell`` and ``control.readings`` take it unchanged: a sound
run is correct, the fp8 control fails the limit, and so do answers
rolled onto the next request.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vigbench import control, harness

HERE = Path(__file__).resolve().parent
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())

CFG = {
    "name": "olmo_1b_smoke", "family": "lm_stub", "dtype": "bfloat16",
    "allow_tf32": False, "layers": 2, "d_model": 64, "heads": 4, "kv_heads": 4,
    "head_dim": 16, "d_ff": 128, "vocab": 256, "rope_theta": 1e4,
    "slots": 4, "max_len": 16, "pool_prompts": 8, "prompt_tokens": [4, 12],
    "new_tokens": 4,
}
MIX = {"loop": "open", "rate_per_s": 40, "burst_share": 0.25, "burst_size": 4,
       "arrival_seed": 0, "warm_buckets": [1], "trace_from": 0.75, "trace_ticks": 4}
# Set from control.readings of the stub on the CPU, seeds 2**31 + 11 and
# 9001-9015, 0.5 s windows of 20 requests: the program's widest gaps
# reached 5.73e-3 (token) and 6.80e-3 nats (log-probability); the fp8
# control's least logprob_gap_max was 3.62e-2 (its token_gap_max fell to
# 4.38e-3: a widest gap of 32 positions need not meet a near tie); the
# rolled answers' least were 0.746 and 0.737.
LIMITS = {"missing": 0, "token_gap_max": 3e-2, "logprob_gap_max": 1.5e-2}
SEED = 2**31 + 11


# -- the stub family: program side -------------------------------------------


def _leaf_shapes(cfg: dict) -> dict[tuple, tuple[tuple[int, ...], int]]:
    """Path in the program's tree -> (shape, contraction size)."""
    n, d, h, kvh, dh, f, v = (cfg[k] for k in (
        "layers", "d_model", "heads", "kv_heads", "head_dim", "d_ff", "vocab"))
    return {
        ("embed", "tokens"): ((v, d), 0),
        ("layers", "mix", "wq"): ((n, d, h, dh), d),
        ("layers", "mix", "wk"): ((n, d, kvh, dh), d),
        ("layers", "mix", "wv"): ((n, d, kvh, dh), d),
        ("layers", "mix", "wo"): ((n, h, dh, d), h * dh),
        ("layers", "mlp", "wi_gate"): ((n, d, f), d),
        ("layers", "mlp", "wi_up"): ((n, d, f), d),
        ("layers", "mlp", "wo"): ((n, f, d), f),
    }


def setup(cfg: dict, seed: int, device):
    """bf16 weights in one draw (the embedding N(0, 0.02^2), the rest
    N(0, 1 / contraction)) and a pool of prompts, from the seed."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    shapes = _leaf_shapes(cfg)
    sizes = [math.prod(s) for s, _ in shapes.values()]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    weights = {}
    for (path, (shape, fan)), part in zip(shapes.items(), torch.split(flat, sizes)):
        sd = 0.02 if fan == 0 else fan ** -0.5
        weights[path] = (part * sd).reshape(shape).to(torch.bfloat16)
    lo, hi = cfg["prompt_tokens"]
    lengths = torch.randint(lo, hi + 1, (cfg["pool_prompts"],), generator=gen,
                            device=device).tolist()
    pool = [torch.randint(0, cfg["vocab"], (n,), generator=gen, device=device)
            for n in lengths]
    host = np.empty(len(pool), dtype=object)
    host[:] = [p.cpu().numpy().astype(np.int32) for p in pool]
    return weights, pool, host


def _tree(weights: dict) -> dict:
    tree = {"final_norm": {}, "layers": {"ln1": {}, "ln2": {}}}
    for path, leaf in weights.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


class System:
    """``ServeEngine`` over ``slots`` slots; ``step()`` returns the
    requests that finished, each ``(uid, answer, (slots, slot))``."""

    def __init__(self, cfg: dict, weights: dict, pool_host, device):
        from repro_torch.configs import olmo_1b
        from repro_torch.serve.engine import Request, ServeEngine

        model = olmo_1b.SMOKE
        assert (model.num_layers, model.d_model, model.num_heads, model.num_kv_heads,
                model.dh, model.d_ff, model.vocab_size, model.rope_theta, model.dtype) == (
            cfg["layers"], cfg["d_model"], cfg["heads"], cfg["kv_heads"],
            cfg["head_dim"], cfg["d_ff"], cfg["vocab"], cfg["rope_theta"], cfg["dtype"])
        self.engine = ServeEngine(model, _tree(weights), slots=cfg["slots"],
                                  max_len=cfg["max_len"], device=device)
        self._request, self.pool, self.new = Request, pool_host, cfg["new_tokens"]
        self._emitted = [[] for _ in range(cfg["slots"])]
        self._answers: dict[int, list] = {}
        self._width = 0
        decode = self.engine._step_decode

        def recorded(tokens, pos, members):
            logits = decode(tokens, pos, members)
            rows = logits[members, -1].float()
            best, lse = rows.amax(-1), torch.logsumexp(rows, -1)
            for s, tok, b, z in zip(members, rows.argmax(-1).tolist(),
                                    best.tolist(), lse.tolist()):
                self._emitted[s].append((tok, tok, b, z))
            return logits

        self.engine._step_decode = recorded

    def submit(self, uid: int, item: int) -> None:
        self.engine.submit(self._request(uid=uid, prompt=self.pool[item],
                                         max_new_tokens=self.new))
        self._answers[uid] = []

    def queued(self) -> int:
        return len(self._answers)

    def step(self) -> list:
        for rows in self._emitted:
            rows.clear()
        self._width = self.engine.step()
        out = []
        for s, req in enumerate(self.engine.slot_req):
            if req is None or req.uid not in self._answers:
                continue
            got = self._answers[req.uid]
            fresh = len(req.out_tokens) - len(got)
            got += self._emitted[s][len(self._emitted[s]) - fresh:]
            if req.done:
                answer = np.array(self._answers.pop(req.uid), dtype=np.float64)
                assert answer[:, 1].tolist() == req.out_tokens
                out.append((req.uid, answer, (len(self.engine.slot_req), s)))
        return out

    def last_bucket(self):
        return self._width


def warm(system: System, mix: dict, pool: int) -> None:
    for uid in range(-1, -1 - pool, -1):
        system.submit(uid, -uid - 1)
    while system.queued():
        system.step()


def build_seconds() -> float:
    return 0.0


# -- the stub family: reference side -------------------------------------------


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to fp8 e4m3 under a per-tensor scale (its largest
    magnitude at e4m3's largest, 448), back in fp32."""
    scale = t.abs().amax().clamp_min(1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        a, b = _fp8(a), _fp8(b)
    return a @ b


def _ln(x: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt((x - mu).square().mean(-1, keepdim=True) + 1e-5)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """(S, H, dh), position = row: each half-pair (i, i + dh/2) rotated by
    position / theta^(i / (dh/2))."""
    s, _, dh = x.shape
    half = dh // 2
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] / theta ** (
        torch.arange(half, dtype=torch.float32, device=x.device) / half)
    cos, sin = ang.cos()[:, None], ang.sin()[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def lm_logits(cfg: dict, w: dict, tokens: torch.Tensor, precision: str) -> torch.Tensor:
    """Plain OLMo forward over one sequence: (S,) -> (S, V) fp32 logits.
    Non-parametric LayerNorm, NeoX RoPE, causal softmax attention with
    grouped KV heads, SwiGLU, tied embeddings."""
    n, d, h, kvh, dh = (cfg[k] for k in ("layers", "d_model", "heads", "kv_heads",
                                         "head_dim"))
    f32 = {path: leaf.float() for path, leaf in w.items()}
    emb = f32[("embed", "tokens")]
    x = emb[tokens.long()]
    s = x.shape[0]
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    for i in range(n):
        def proj(name, heads):
            return _mm(_ln(x), f32[("layers", "mix", name)][i].reshape(d, heads * dh),
                       precision).reshape(s, heads, dh)
        q = _rope(proj("wq", h), cfg["rope_theta"])
        k = _rope(proj("wk", kvh), cfg["rope_theta"])
        v = proj("wv", kvh)
        heads = []
        for j in range(h):
            kv = j // (h // kvh)
            score = _mm(q[:, j], k[:, kv].T, precision) * dh ** -0.5
            p = torch.softmax(score.masked_fill(~causal, -math.inf), -1)
            heads.append(_mm(p, v[:, kv], precision))
        wo = f32[("layers", "mix", "wo")][i].reshape(h * dh, d)
        x = x + _mm(torch.cat(heads, -1), wo, precision)
        g = _mm(_ln(x), f32[("layers", "mlp", "wi_gate")][i], precision)
        u = _mm(_ln(x), f32[("layers", "mlp", "wi_up")][i], precision)
        x = x + _mm(torch.nn.functional.silu(g) * u, f32[("layers", "mlp", "wo")][i],
                    precision)
    return _mm(_ln(x), emb.T, precision)


class Teacher:
    """The reference teacher-forced on an answer's sequence: ``(item,
    tokens) -> (T, V)`` logits, row t the position that emitted token t."""

    def __init__(self, cfg, weights, pool, precision):
        self.cfg, self.weights, self.pool = cfg, weights, pool
        self.precision, self.new = precision, cfg["new_tokens"]
        self._seen: dict = {}

    def __call__(self, item: int, tokens: np.ndarray) -> np.ndarray:
        key = (item, tokens.tobytes())
        if key not in self._seen:
            prompt = self.pool[item]
            seq = torch.cat([prompt, torch.as_tensor(tokens[:-1], dtype=prompt.dtype,
                                                     device=prompt.device)])
            with torch.inference_mode():
                rows = lm_logits(self.cfg, self.weights, seq, self.precision)
            self._seen[key] = rows[len(prompt) - 1:].double().cpu().numpy()
        return self._seen[key]


def reference(cfg, weights, pool, precision="fp32") -> Teacher:
    return Teacher(cfg, weights, pool, precision)


def _lse(rows: np.ndarray) -> np.ndarray:
    top = rows.max(-1)
    return np.log(np.exp(rows - top[:, None]).sum(-1)) + top


def _gaps(answer, ref: Teacher, item: int):
    """(token gaps, log-probability gaps) of one answer's judged
    tokens, the reference teacher-forced on its sequence; None when it is
    malformed (not ``new_tokens`` rows of in-vocabulary tokens)."""
    a = np.asarray(answer, dtype=np.float64)
    if a.shape != (ref.new, 4):
        return None
    tokens = a[:, :2]
    if not np.all((tokens >= 0) & (tokens < ref.cfg["vocab"]) & (tokens == np.round(tokens))):
        return None
    rows = ref(item, a[:, 0].astype(np.int64))
    at = rows[np.arange(len(a)), a[:, 1].astype(np.int64)]
    return rows.max(-1) - at, np.abs((a[:, 2] - a[:, 3]) - (at - _lse(rows)))


def held(window, ref: Teacher, limits) -> dict:
    """``missing``; over every emitted token, the widest gap by which its
    reference logit lies below the reference's best (``token_gap_max``)
    and the widest gap between its log-probabilities
    (``logprob_gap_max``). A malformed answer reads inf."""
    missing, tok, lp = 0, [0.0], [0.0]
    for r in window.requests:
        if r.failed or r.answer is None:
            missing += 1
            continue
        gaps = _gaps(r.answer, ref, r.item)
        tok += [math.inf] if gaps is None else gaps[0].tolist()
        lp += [math.inf] if gaps is None else gaps[1].tolist()
    return {"missing": missing, "token_gap_max": max(tok),
            "logprob_gap_max": max(lp)}


def compare(window, ref: Teacher, limits) -> dict:
    numbers = held(window, ref, limits)
    return {k: {"value": float(numbers[k]), "limit": float(limits[k])}
            for k in ("missing", "token_gap_max", "logprob_gap_max")}


def controls(cfg, weights, pool, window, ref) -> dict:
    """The fp8 reference in the program's place, teacher-forced on the
    program's sequence, its own first token judged at each position; and
    each answer rolled onto the next request."""
    low = reference(cfg, weights, pool, "fp8")
    answered = [r for r in window.requests if r.answer is not None]

    def fp8_answer(r):
        seq = np.asarray(r.answer)[:, 0]
        rows = low(r.item, seq.astype(np.int64))
        return np.stack([seq, rows.argmax(-1), rows.max(-1), _lse(rows)], -1)

    def swap(answers):
        return dataclasses.replace(window, requests=[
            dataclasses.replace(r, answer=a) for r, a in zip(answered, answers)])

    return {"control_fp8": swap([fp8_answer(r) for r in answered]),
            "answers_rolled": swap([r.answer for r in answered[1:] + answered[:1]])}


CONTROL_BREAKS = {"control_fp8": "logprob_gap_max", "answers_rolled": "token_gap_max"}


FAMILY = SimpleNamespace(
    setup=setup, System=System, warm=warm, build_seconds=build_seconds,
    reference=reference, compare=compare, held=held, controls=controls,
    CONTROL_BREAKS=CONTROL_BREAKS)


@pytest.fixture
def stub(monkeypatch):
    monkeypatch.setattr(harness, "load_family", lambda name: FAMILY)
    return FAMILY


# -- tests -------------------------------------------------------------------


def test_the_reference_agrees_with_the_program_in_fp32():
    """The plain forward is the program's model: the port's forward in
    fp32, on the same weights, matches it to rounding."""
    from repro_torch.configs import olmo_1b
    from repro_torch.models import transformer as tr

    weights, pool, _ = setup(CFG, SEED, "cpu")
    f32 = {k: v.float() for k, v in weights.items()}
    model = olmo_1b.SMOKE.replace(dtype="float32")
    seq = pool[0]
    got, _ = tr.forward(tr.compute_params(_tree(f32), model), seq[None], model)
    want = lm_logits(CFG, weights, seq, "fp32")
    assert torch.allclose(got[0].float(), want, atol=1e-5, rtol=1e-5)


def test_the_stub_keeps_the_family_contract():
    from vigbench import families

    assert all(hasattr(FAMILY, name) for name in families.CONTRACT)
    assert all(callable(getattr(System, name)) for name in families.SYSTEM)


def _run(seed=SEED):
    return harness.run_cell(
        cfg=CFG, mix=MIX, limits=LIMITS,
        metrics=harness.cell_metrics(BENCH, "iso224-poisson", trace=False),
        seed=seed, seconds=0.5, trace=False, device="cpu",
        t_process=time.perf_counter())


def test_a_sound_bf16_run_is_correct(stub):
    result = _run()
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] == round(MIX["rate_per_s"] * 0.5)
    assert set(result["checks"]) == set(LIMITS)
    assert {"latency_p95_ms", "latency_p50_ms", "setup_s"} <= set(result["metrics"])


@pytest.mark.parametrize("seed", [SEED, 9013])
def test_readings_hold_the_program_and_refuse_each_control(stub, seed):
    out = control.readings(CFG, MIX, LIMITS, seed, 0.5, "cpu")
    program = out["program"]
    assert program["missing"] == 0
    for name in program.keys() & LIMITS.keys():
        assert program[name] <= LIMITS[name], name
    assert set(out) == {"seed", "requests", "reference_s", "program", *CONTROL_BREAKS}
    for name, number in CONTROL_BREAKS.items():
        assert out[name][number] > LIMITS[number], name


def test_answers_rolled_onto_the_next_request_are_not_correct(stub, monkeypatch):
    """Each finished request carries the answer of the request that
    finished before it, warm-up's included."""
    step = System.step
    carry = []

    def rolled(self):
        done = step(self)
        answers = carry + [a for _, a, _ in done]
        carry[:] = answers[-1:]
        return [(uid, a, lane) for (uid, _, lane), a in zip(done, answers)]

    monkeypatch.setattr(System, "step", rolled)
    result = _run()
    assert result["correct"] is False
    assert result["checks"]["token_gap_max"]["value"] > LIMITS["token_gap_max"]
