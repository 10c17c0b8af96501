"""The LM family: ``repro_torch``'s ``ServeEngine`` serving greedy
generation requests in bf16, each prompt prefilled whole into its slot's
cache rows (``prefill="whole"``), every active slot decoded one token a
tick. The configuration file is a DeepSeek-V2 ``config.json`` (its keys)
with the deployment's and the benchmark's own keys beside them.

- Weights: drawn from the seed on the device, one leaf at a time in
  sorted path order: the embedding N(0, 0.02^2), every other matrix
  N(0, 1 / its contraction), norm scales 1; held in bf16 but the router
  and the norm scales (fp32, as the program holds them).
- The pool: ``pool_prompts`` prompts whose lengths are the log-normal's
  quantiles (``prompt_tokens``: median, sigma of the log, clipped), ids
  uniform over the vocabulary from the seed. Request ``uid`` asks for
  ``answer_tokens(cfg, uid)`` new tokens: the answer-length log-normal's
  ``cycle`` quantiles in an order drawn once from ``answer_order_seed``,
  cycled. ``cycle`` is a window's request count, so that, as with the
  arrivals (``traffic.py``), every window offers each quantile once and
  every seed the same lengths in the same order; the seed draws the
  prompts.
- The steady state: ``warm`` offers ``steady_s`` seconds of the mix's
  own traffic before the window and leaves its requests in flight, so
  that the window starts from the engine's steady occupancy, not from an
  empty engine; the System ticks for them and returns none of them.
- An answer is one row per emitted token: the token the sequence went on
  with, the token judged there (for the program the same one), the logit
  the program gave it and its row's log-sum-exp, all read in the tick's
  one device read. Its lane is ``(slots, slot)``.
- ``reference`` is a teacher: the plain fp32 forward
  (``reference/deepseek_v2_plain.py``), teacher-forced on each answer's
  own tokens, since near-tied top logits of random weights flip under
  rounding and a continuation of its own would part from the program's.
  It runs every answered sequence together, layer by layer.
- The controls: the same reference one step below bf16 (every matrix
  product's operands rounded to fp8 e4m3) in the program's place,
  teacher-forced on the program's prompts and tokens, its own first
  token judged at each position; and answers moved between requests at
  lengths their requests asked for (a slot mix-up that the length check
  cannot see).
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import time

import numpy as np
import torch

from vigbench.reference import deepseek_v2_plain as plain

DRAW = 1 << 27  # elements drawn in fp32 at a time into a bf16 leaf


def leaf_shapes(cfg: dict) -> dict[tuple, tuple[tuple[int, ...], int]]:
    """Path -> (shape, contraction): the program's parameter tree
    (``transformer.param_spec`` of a ``DeepSeekV2Config``); contraction
    0 marks the embedding, -1 a norm scale."""
    d, v = int(cfg["hidden_size"]), int(cfg["vocab_size"])
    h, nope = int(cfg["num_attention_heads"]), int(cfg["qk_nope_head_dim"])
    rope, dv = int(cfg["qk_rope_head_dim"]), int(cfg["v_head_dim"])
    lora = int(cfg["kv_lora_rank"])
    e, f = int(cfg["n_routed_experts"]), int(cfg["moe_intermediate_size"])
    fs = f * int(cfg["n_shared_experts"])
    n_dense = int(cfg["first_k_dense_replace"])
    out = {("embed", "tokens"): ((v, d), 0), ("embed", "unembed"): ((d, v), d),
           ("final_norm", "scale"): ((d,), -1)}

    def mix(block, n):
        out.update({
            (block, "ln1", "scale"): ((n, d), -1), (block, "ln2", "scale"): ((n, d), -1),
            (block, "mix", "wq"): ((n, d, h, nope + rope), d),
            (block, "mix", "w_dkv"): ((n, d, lora), d),
            (block, "mix", "w_kpe"): ((n, d, rope), d),
            (block, "mix", "kv_norm"): ((n, lora), -1),
            (block, "mix", "w_uk"): ((n, lora, h, nope), lora),
            (block, "mix", "w_uv"): ((n, lora, h, dv), lora),
            (block, "mix", "wo"): ((n, h, dv, d), h * dv),
        })

    def swiglu(prefix, n, width):
        out.update({prefix + ("wi_gate",): ((n, d, width), d),
                    prefix + ("wi_up",): ((n, d, width), d),
                    prefix + ("wo",): ((n, width, d), width)})

    mix("dense", n_dense)
    swiglu(("dense", "mlp"), n_dense, int(cfg["intermediate_size"]))
    n = int(cfg["num_hidden_layers"]) - n_dense
    mix("layers", n)
    out.update({("layers", "mlp", "router"): ((n, d, e), d),
                ("layers", "mlp", "w_gate"): ((n, e, d, f), d),
                ("layers", "mlp", "w_up"): ((n, e, d, f), d),
                ("layers", "mlp", "w_down"): ((n, e, f, d), f)})
    swiglu(("layers", "mlp", "shared"), n, fs)
    return out


def _draw(shape, sd: float, dtype, gen: torch.Generator) -> torch.Tensor:
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    flat = out.view(-1)
    for start in range(0, flat.numel(), DRAW):
        part = flat[start:start + DRAW]
        part.copy_(torch.randn(part.numel(), generator=gen, device=gen.device).mul_(sd))
    return out


def _lognormal_quantiles(spec: dict, count: int) -> np.ndarray:
    """``count`` lengths at the quantiles (i + 0.5) / count of the
    log-normal ``spec`` (median, sigma of the log), rounded and clipped
    to [min, max]."""
    z = [statistics.NormalDist().inv_cdf((i + 0.5) / count) for i in range(count)]
    lengths = np.round(float(spec["median"]) * np.exp(float(spec["sigma_log"]) * np.array(z)))
    return np.clip(lengths, int(spec["min"]), int(spec["max"])).astype(np.int64)


def answer_tokens(cfg: dict, uid: int) -> int:
    """The new tokens request ``uid`` asks for (``answer_tokens``'s
    quantiles, cycled in a fixed order)."""
    spec = cfg["answer_tokens"]
    count = int(spec["cycle"])
    table = np.random.default_rng(int(cfg["answer_order_seed"])).permutation(
        _lognormal_quantiles(spec, count))
    return int(table[uid % count])


def setup(cfg: dict, seed: int, device):
    """The weights (bf16, the router and norm scales fp32) and the prompt
    pool, from the seed, on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    weights = {}
    for path, (shape, fan) in sorted(leaf_shapes(cfg).items()):
        # The router and the norm scales in fp32, as the program holds them.
        dtype = torch.float32 if fan < 0 or path[-1] == "router" else torch.bfloat16
        if fan < 0:
            weights[path] = torch.ones(shape, dtype=dtype, device=device)
        else:
            weights[path] = _draw(shape, 0.02 if fan == 0 else fan ** -0.5, dtype, gen)
    lengths = _lognormal_quantiles(cfg["prompt_tokens"], int(cfg["pool_prompts"]))
    vocab = int(cfg["vocab_size"])
    pool = [torch.randint(0, vocab, (int(n),), generator=gen, device=device)
            for n in lengths]
    host = np.empty(len(pool), dtype=object)
    host[:] = [p.cpu().numpy().astype(np.int32) for p in pool]
    return weights, pool, host


def model_config(cfg: dict):
    """The port's ``DeepSeekV2Config`` of the configuration file."""
    from repro_torch.models.config import DeepSeekV2Config, MLAConfig, MoEConfig, YarnConfig

    rs = cfg["rope_scaling"]
    if rs["type"] != "yarn" or cfg["q_lora_rank"] is not None or cfg["scoring_func"] != "softmax":
        raise ValueError("the lm family serves DeepSeek-V2 with YaRN, no query "
                         "LoRA and a softmax router")
    if cfg["routed_scaling_factor"] != 1 or cfg["n_group"] != 1 or cfg["topk_group"] != 1:
        raise ValueError("the port's MoE has no routed scaling and no group limit")
    return DeepSeekV2Config(
        name=cfg["name"], family="moe", num_layers=int(cfg["num_hidden_layers"]),
        d_model=int(cfg["hidden_size"]), num_heads=int(cfg["num_attention_heads"]),
        num_kv_heads=int(cfg["num_key_value_heads"]),
        d_ff=int(cfg["moe_intermediate_size"]), vocab_size=int(cfg["vocab_size"]),
        rope_theta=float(cfg["rope_theta"]), tie_embeddings=bool(cfg["tie_word_embeddings"]),
        mla=MLAConfig(kv_lora=int(cfg["kv_lora_rank"]),
                      qk_nope_dim=int(cfg["qk_nope_head_dim"]),
                      qk_rope_dim=int(cfg["qk_rope_head_dim"]),
                      v_dim=int(cfg["v_head_dim"])),
        moe=MoEConfig(num_experts=int(cfg["n_routed_experts"]),
                      top_k=int(cfg["num_experts_per_tok"]),
                      d_expert=int(cfg["moe_intermediate_size"]),
                      num_shared=int(cfg["n_shared_experts"])),
        dense_layers=int(cfg["first_k_dense_replace"]),
        dense_d_ff=int(cfg["intermediate_size"]), norm_topk=bool(cfg["norm_topk_prob"]),
        yarn=YarnConfig(factor=float(rs["factor"]),
                        original_max_position=int(rs["original_max_position_embeddings"]),
                        beta_fast=float(rs["beta_fast"]), beta_slow=float(rs["beta_slow"]),
                        mscale=float(rs["mscale"]),
                        mscale_all_dim=float(rs["mscale_all_dim"])),
        dtype=cfg["dtype"])


def _tree(weights: dict) -> dict:
    tree: dict = {}
    for path, leaf in weights.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


class System:
    """``ServeEngine`` over ``slots`` slots with whole-prompt prefill;
    ``step()`` returns the requests that finished, each ``(uid, answer,
    (slots, slot))``."""

    def __init__(self, cfg: dict, weights: dict, pool_host, device):
        from repro_torch.serve.engine import Request, ServeEngine

        self.engine = ServeEngine(model_config(cfg), _tree(weights),
                                  slots=int(cfg["slots"]), max_len=int(cfg["max_len"]),
                                  device=device, prefill="whole")
        self.cfg, self._request, self.pool = cfg, Request, pool_host
        self._live: dict[int, object] = {}
        self._load: set[int] = set()  # the steady load's uids in flight
        self._width = 0

    def submit(self, uid: int, item: int, new_tokens=None) -> None:
        req = self._request(uid=uid, prompt=self.pool[item],
                            max_new_tokens=new_tokens or answer_tokens(self.cfg, uid))
        self.engine.submit(req)
        self._live[uid] = req

    def load(self, i: int, item: int) -> None:
        """The steady load's ``i``-th request (a negative uid below the
        warm-up's), asking for the length the window's ``i``-th does."""
        uid = -len(self.pool) - 1 - i
        self.engine.submit(self._request(uid=uid, prompt=self.pool[item],
                                         max_new_tokens=answer_tokens(self.cfg, i)))
        self._load.add(uid)

    def queued(self) -> int:
        """The requests submitted and not returned, and the steady load's
        in flight: the engine ticks while either waits."""
        return len(self._live) + len(self._load)

    def step(self) -> list:
        self.engine.step()
        self._width = self.engine.slots
        out = []
        for s, req in enumerate(self.engine.slot_req):
            if req is not None and req.done:
                self._load.discard(req.uid)
            if req is not None and req.done and req.uid in self._live:
                del self._live[req.uid]
                answer = np.array([(t, t, logit, lse) for t, (logit, lse)
                                   in zip(req.out_tokens, req.out_scores)],
                                  dtype=np.float64)
                out.append((req.uid, answer, (self.engine.slots, s)))
        return out

    def last_bucket(self):
        return self._width


def warm(system: System, mix: dict, pool: int) -> None:
    """Every prompt of the pool prefilled, and a decode step of every
    slot: each shape the window serves. Then, for an open loop, the
    steady load: ``steady_s`` seconds of the mix's own arrivals (items
    from ``steady_seed``), whose requests stay in flight into the window."""
    for uid in range(-1, -1 - pool, -1):
        system.submit(uid, -uid - 1, new_tokens=2)
    while system.queued():
        system.step()
    seconds = float(mix.get("steady_s", 0.0))
    if mix["loop"] != "open" or seconds <= 0:
        return
    from vigbench import traffic

    due, items = traffic.open_schedule(mix, seconds, int(mix["steady_seed"]), pool)
    start, i = time.perf_counter(), 0
    while (now := time.perf_counter() - start) < seconds:
        while i < len(due) and due[i] <= now:
            system.load(i, int(items[i]))
            i += 1
        if system.queued():
            system.step()
        else:
            time.sleep(max(0.0, min(seconds, due[i] if i < len(due) else seconds) - now))


def build_seconds() -> float:
    return 0.0  # the LM path builds no kernel


# -- the reference side -------------------------------------------------------


class Teacher:
    """The plain forward teacher-forced on answers' sequences:
    ``score(item, tokens, judged)`` gives, at each position that emitted a
    token, the reference's best logit, its argmax, its row's log-sum-exp
    and its logit at ``judged``; ``prepare`` runs many sequences in one
    layer-by-layer pass."""

    def __init__(self, cfg, weights, pool, precision):
        self.cfg, self.pool = cfg, pool
        self.forward = plain.Forward(cfg, weights, precision)
        self._hidden: dict = {}

    def _key(self, item: int, tokens: np.ndarray):
        return item, np.asarray(tokens, dtype=np.int64).tobytes()

    def prepare(self, answers) -> None:
        """``answers``: (item, tokens) pairs; each sequence is its prompt
        and its tokens but the last."""
        seqs = {}
        for item, tokens in answers:
            key = self._key(item, tokens)
            if key in self._hidden or key in seqs:
                continue
            prompt = self.pool[item]
            rest = torch.as_tensor(np.asarray(tokens[:-1], dtype=np.int64),
                                   device=prompt.device)
            seqs[key] = (torch.cat([prompt.long(), rest]), len(prompt) - 1)
        if seqs:
            self._hidden.update(self.forward.run(seqs))

    def score(self, item: int, tokens, judged) -> np.ndarray:
        key = self._key(item, tokens)
        if key not in self._hidden:
            self.prepare([(item, tokens)])
        rows = self.forward.logits(self._hidden[key])
        at = rows.gather(1, torch.as_tensor(np.asarray(judged, dtype=np.int64),
                                            device=rows.device)[:, None])[:, 0]
        best, arg = rows.max(-1)
        out = torch.stack([best, arg.float(), torch.logsumexp(rows, -1), at], -1)
        return out.double().cpu().numpy()


def reference(cfg, weights, pool, precision="fp32") -> Teacher:
    return Teacher(cfg, weights, pool, precision)


def _well_formed(a: np.ndarray, vocab: int) -> bool:
    tokens = a[:, :2]
    return (a.ndim == 2 and a.shape[1] == 4 and len(a) > 0
            and bool(np.all((tokens >= 0) & (tokens < vocab) & (tokens == np.round(tokens))))
            and bool(np.all(np.isfinite(a[:, 2:]))))


def held(window, ref: Teacher, limits) -> dict:
    """``missing``; over every emitted token, the widest gap by which its
    reference logit lies below the reference's best (``token_gap_max``)
    and the widest gap between its log-probabilities
    (``logprob_gap_max``). A malformed answer, or one of another length
    than its request asked for, reads inf."""
    vocab = int(ref.cfg["vocab_size"])
    missing, tok, lp, sound = 0, [0.0], [0.0], []
    for r in window.requests:
        if r.failed or r.answer is None:
            missing += 1
            continue
        a = np.asarray(r.answer, dtype=np.float64)
        if a.ndim != 2 or len(a) != answer_tokens(ref.cfg, r.uid) or not _well_formed(a, vocab):
            tok.append(math.inf)
            lp.append(math.inf)
        else:
            sound.append((r.item, a))
    ref.prepare([(item, a[:, 0].astype(np.int64)) for item, a in sound])
    for item, a in sound:
        s = ref.score(item, a[:, 0].astype(np.int64), a[:, 1].astype(np.int64))
        best, lse, at = s[:, 0], s[:, 2], s[:, 3]
        tok += (best - at).tolist()
        lp += np.abs((a[:, 2] - a[:, 3]) - (at - lse)).tolist()
    return {"missing": missing, "token_gap_max": max(tok), "logprob_gap_max": max(lp)}


def compare(window, ref: Teacher, limits) -> dict:
    numbers = held(window, ref, limits)
    return {k: {"value": float(numbers[k]), "limit": float(limits[k])}
            for k in ("missing", "token_gap_max", "logprob_gap_max")}


def _moved(answers: list) -> list:
    """Each answer replaced by the next one as long or longer (by length,
    then order), cut to its own length; the longest keeps its own. Every
    answer keeps the length its request asked for, so only the tokens
    and scores can show the mix-up."""
    order = sorted(range(len(answers)), key=lambda k: (len(answers[k]), k))
    out = list(answers)
    for a, b in zip(order, order[1:]):
        out[a] = np.asarray(answers[b])[:len(answers[a])]
    return out


def controls(cfg, weights, pool, window, ref) -> dict:
    """The fp8 reference in the program's place, teacher-forced on the
    program's sequence, its own first token judged at each position; and
    answers moved between requests at their own lengths (``_moved``)."""
    low = reference(cfg, weights, pool, "fp8")
    answered = [r for r in window.requests if r.answer is not None]
    low.prepare([(r.item, np.asarray(r.answer)[:, 0].astype(np.int64)) for r in answered])

    def fp8_answer(r):
        seq = np.asarray(r.answer)[:, 0].astype(np.int64)
        s = low.score(r.item, seq, seq)
        return np.stack([seq, s[:, 1], s[:, 0], s[:, 2]], -1)

    def swap(answers):
        return dataclasses.replace(window, requests=[
            dataclasses.replace(r, answer=a) for r, a in zip(answered, answers)])

    return {"control_fp8": swap([fp8_answer(r) for r in answered]),
            "answers_rolled": swap(_moved([r.answer for r in answered]))}


CONTROL_BREAKS = {"control_fp8": "logprob_gap_max", "answers_rolled": "token_gap_max"}
