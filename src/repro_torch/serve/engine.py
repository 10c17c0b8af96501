"""Batched serving engines (port of ``repro/serve/engine.py``).

``ServeEngine``: LM greedy decoding over fixed batch slots
(continuous-batching-lite). A request takes a free slot, its prompt is
fed token by token through ``decode_step`` (the cache layout decode
uses; JAX's engine), or with ``prefill="whole"`` as one prefill of the
whole prompt written into the slot's cache rows, and each tick decodes
every active slot in one call with the per-slot position vector. Each call commits only its member rows: their
new keys and values are written into the engine's cache in place (where
JAX merges rows under a mask and donates the cache), so a slot that is
not a member, prefilling or idle, keeps its cache bit for bit. The engine
holds its parameters in the config's compute dtype (one cast, made when
it is built) and decodes eagerly.

``VigServeEngine``: multi-tenant bucketed ViG inference (the request path
of JAX's ``VigServeEngine``).

Requests occupy fixed slots (``slots = max(buckets)``). Each tick gathers
the queued requests' slots, one lane per tenant, pads the batch to the
smallest bucket that fits and runs that bucket's program. A tenant keeps
its slot across ticks; a new tenant takes a free slot first, else the
least recently used idle one. ``buckets=None`` is the exact-size policy:
one program per exact active batch size.

DIGC state is per slot: one canonical ``DigcState`` with a row per slot
(``init_vig_state(per_slot=True)``). A tick takes the picked lanes' rows,
pads them (image and state row) by replicating lane 0, runs the program
with that state and scatters only the live lanes back, so a tenant's
warm state (the blocked tier's cached graph under a ``reuse`` policy)
follows it across buckets and padding lanes never clobber live rows. A
slot bound to a new tenant is cold-reset first; an LRU-evicted tenant's
rows are parked in host memory (at most ``park_capacity`` tenants, the
oldest copy dropped first) and restored when it returns. ``release()``
drops a tenant and its parked copy. The ``cuda`` tier is stateless: its
program passes its state through, and the tick scatters nothing back.

The row lifecycle makes no host round trip: a tick writes its rows (the
padded lanes, then the slots admission bound cold) into one pinned host
buffer, copies it to the card once without waiting, and the tick's
gather, scatter and admission resets at every size index with that one
device tensor; admission's cold resets are applied together, once per
entry. Resets and restores off the tick (release, quarantine, recovery,
unparking) index one slot with a tensor filled on the device.

The multi-resolution lattice (``image_sizes=``, DESIGN.md §13): each
configured image size is an N-bucket with its own per-slot state
(``_slot_states[size]``), programs and schedules. A request of a
configured size serves unmasked; a ragged size is zero-padded up to the
smallest size that fits and carries a live-node mask (``valid_mask``) that
keeps its pad nodes out of every top-k and the pooling (single-stage
r = 1 models and a pad-capable DIGC tier only: ``cuda`` is not one, so
padded cells serve on ``blocked``). A tick serves one (size, masked) cell,
so a mixed trace builds at most |buckets| x |image_sizes| programs (twice
that with padded cells). Parked copies hold every allocated size's rows.
Without ``image_sizes`` the engine is single-size, with the exact-shape
submit contract and bare-bucket program keys.

SLO-bounded admission (``slo_ms``, ``clock``, ``prefetch``; DESIGN.md
§14): a positive ``slo_ms`` (scalar ms, or ``{tenant class: ms}`` keyed by
``VigRequest.tclass``) arms the scheduler. A tick then dispatches a cell
only when its earliest member deadline has arrived or it holds a full
slot width of tenants, and defers otherwise (``deferrals``; ``run()``
advances the clock to the next deadline). ``clock`` injects the time
source (``serve.sched.VirtualClock`` in tests), and ``prefetch`` starts a
parked tenant's host -> device row upload when the queue names it for the
next tick. ``slo_ms=0`` (the default) is the bind-on-next-tick engine.

Each bucket (or lattice cell) has one program, the counterpart of the JAX
engine's jitted program (``mode="jit"``; ``mode="eager"`` makes the
request path raise, as in JAX, and is the legacy shim of the direct path:
on a tier with ``supports_cache`` (``cluster``) ``infer`` runs the forward
through the engine's host-side ``DigcCache``, warm-starting across layers
and calls and reported in ``stats()["digc_cache"]``; every other tier
serves as in ``mode="jit"``). On a card the program is captured as one
``torch.cuda.CUDAGraph``: a cell's first tick is served eagerly on the
capture stream (the capture's warm-up) and then captured from static
buffers (the cell's device image buffer, filled from a pinned staging
buffer, a padded cell's device mask buffer, filled the same way, and the
tick's state rows); every later tick copies its rows into the static
inputs, replays, and scatters from the static outputs. Captured programs
are counted in ``compile_count`` (and reported to ``on_compile``); on the
CPU there is nothing to capture, the program runs eagerly and is counted
when it is built. A replay launches the kernels the capture recorded
without calling their wrappers, so the engine adds the capture's launch
tally to the counters at each replay.

Fault tolerance (DESIGN.md §11): ``fault_plan`` (``core.faults``) injects
failures at the engine's sites; ``guards=True`` screens each picked lane
before it reaches the program (a non-finite image or non-finite state
rows quarantine the lane; rows whose checksum tokens no longer match are
served cold), while co-batched lanes are served as if the faulty one never
existed. The screen is taken on the device and pulled once a tick
(``DigcState.row_checks``, where JAX fingerprints rows with crc32 on the
host); the new tokens of the rows a tick writes ride its logits' transfer.
Tokens are kept per (size, slot). A failing program build is retried with
backoff and then walks the degradation ladder
(``core.builder.fallback_chain``: ``cuda`` -> ``blocked`` ->
``reference``), as do ``deadline_strikes`` consecutive ticks over
``deadline_ms`` (a program's first tick, which captures, never counts). A
capture or launch error is not a build failure: it raises out of
``step()``.

With the config's ``blocked`` tier and ``autotune=True`` the DIGC
schedule is tuned (``core.tuner``): ``warmup()`` tunes a per-stage
``VigSchedule`` at ``batch`` for the direct path, and a cell's first tick
tunes one schedule per configured bucket at that size (before any
capture), whose candidates include the ``cuda`` kernel with both of its
merges. The tuner's host-keyed JSON cache (``tuner_path``) makes a later
engine tune nothing, and also keeps the bucket set that
``retune_buckets()`` derives from the served trace's live-lane histogram,
which ``buckets="auto"`` reads back. The direct path (``infer``) runs
eagerly.

Mesh-native serving (``mesh=``, DESIGN.md §10): the construction spec is
threaded with the mesh (``mesh_axis`` names the co-node ring axis,
``mesh_batch_axis`` optionally shards a tick's rows data-parallel), the
slot state is allocated placed (``init_vig_state(mesh=)``), and every
cell's program runs the ring builder. SPMD: every rank runs the same
engine on the same requests and gets the same logits; only the ring's
shards differ between ranks. A tick whose bucket the batch axis does not
divide is padded up to the next multiple (``_tick_width``), its padding
lanes replicating lane 0. On a one-rank mesh no collective is issued, so
the bucket programs are captured on a card as they are without a mesh.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core.builder import degraded_spec, fallback_chain, get_builder
from repro_torch.core.digc import gate_reads
from repro_torch.core.engine import DigcCache
from repro_torch.core.faults import FaultError, FaultInfo
from repro_torch.core.state import FIELDS, DigcState, prefetch_park_rows
from repro_torch.core.tuner import DigcTuner, VigSchedule, optimal_bucket_set
from repro_torch.device import resolve_device
from repro_torch.kernels import add_launch_counts, uncounted_launches
from repro_torch.models import transformer as tr
from repro_torch.models.config import ModelConfig
from repro_torch.models.vig import (
    count_digc_work,
    init_vig_state,
    resolve_digc_spec,
    vig_forward,
    vig_stage_plans,
)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 16
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    # (logit, log-sum-exp of its row) of each emitted token
    out_scores: list = dataclasses.field(default_factory=list)


# The attributes of ``ServeEngine``'s spans (``spans.attr_dict``):
# ``lm.step`` (id: the tick), ``lm.prefill`` (id: the uid) and
# ``lm.decode`` (id: the tick). ``device_ms`` is the call's time on the
# card by CUDA events, read after the tick's device read (on the CPU, the
# span's own length); ``kv`` counts the cache positions that the decode's
# rows attend, their new ones included.
LM_STEP_ATTRS = ("prefills", "slots")
LM_PREFILL_ATTRS = ("tokens", "device_ms", "slot")
LM_DECODE_ATTRS = ("kv", "device_ms", "rows")


class ServeEngine:
    """Greedy-decoding engine over the functional model API.

    ``prefill="token"`` (JAX's engine) feeds an admitted prompt through
    decode steps, one token a call. ``prefill="whole"`` runs it as one
    ``transformer.prefill_into``, which writes positions [0, S) of the
    slot's cache rows in place, for a config whose decode cache that
    fills (``transformer.prefills_into_rows``; the others keep the token
    path); a request's prompt and answer must then fit in ``max_len``. A
    whole-prompt tick makes one device read: the admissions' prefills,
    then one decode step of every active slot fed from the device (each
    slot's next input token stays there), then the read of every token
    the tick emitted. Its
    decode step has one shape whatever the slots hold: every row computes,
    and a slot that is not active is given position ``max_len``, where its
    cache write is dropped. On a card that step is captured as a CUDA
    graph when the engine is built and replayed every tick.

    Each emitted token comes with its logit and its row's log-sum-exp
    (``Request.out_scores``), read with the token. ``step()`` records the
    span ``lm.step`` with ``lm.prefill`` (one per admission), ``lm.decode``
    and ``lm.pull`` (the read's wait) inside it, and the counters
    ``lm.prefill_tokens`` and ``lm.decode_tokens``; ``submit`` records
    ``engine.submit``."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 max_len: int = 512, device="cuda", prefill: str = "token"):
        if prefill not in ("token", "whole"):
            raise ValueError(f"prefill must be 'token' or 'whole': {prefill!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = tr.compute_params(params, cfg, device=self.device)
        self.slots = slots
        self.max_len = max_len
        self.cache = tr.init_cache(cfg, slots, max_len, device=self.device)
        self.slot_req: list[Optional[Request]] = [None] * slots
        self.slot_pos = np.zeros(slots, np.int32)
        self.queue: list[Request] = []
        self.decode_calls = 0  # observability: decode steps issued
        self.prefill_calls = 0  # whole-prompt prefills issued
        self.ticks = 0
        self.whole = prefill == "whole" and tr.prefills_into_rows(cfg)
        if self.whole:
            # Each slot's next input token, on the device; the host's
            # staging of a tick's prompts and positions, pinned on a card
            # so that their copies wait on nothing, and rewritten only
            # after the tick's read.
            self._next = torch.zeros((slots, 1), dtype=torch.long,
                                     device=self.device)
            pin = self.device.type == "cuda"
            self._stage_prompts = torch.zeros((slots, max_len), dtype=torch.int32,
                                              pin_memory=pin)
            self._stage_pos = torch.zeros(slots, dtype=torch.long, pin_memory=pin)
            # The decode step's static inputs and outputs.
            self._pos = torch.full((slots,), max_len, dtype=torch.long,
                                   device=self.device)
            self._rows = torch.arange(slots, device=self.device)
            self._decoded = torch.zeros((slots, 3), device=self.device)
            self._graph = self._capture() if pin else None

    def submit(self, req: Request):
        if len(req.prompt) == 0:
            raise ValueError(
                f"request {req.uid}: empty prompt (prefill needs at "
                "least one token to produce a next-token distribution)"
            )
        if req.max_new_tokens < 1:
            raise ValueError(
                f"request {req.uid}: max_new_tokens must be >= 1 "
                "(prefill always emits the first token)"
            )
        if self.whole and len(req.prompt) + req.max_new_tokens - 1 > self.max_len:
            # Its last positions' cache writes would be dropped, and its
            # later tokens computed without them.
            raise ValueError(
                f"request {req.uid}: a {len(req.prompt)}-token prompt and "
                f"{req.max_new_tokens} new tokens exceed max_len {self.max_len}")
        rec = spans.RECORDER
        t0 = spans.now() if rec.enabled else 0
        self.queue.append(req)
        if rec.enabled:
            rec.lap("engine.submit", t0, req.uid)

    def _step_decode(self, tokens, pos, members):
        """One decode step committing only ``members``' cache rows, in
        place. ``pos`` is the (slots,) per-slot position vector: a single
        call serves arbitrarily mixed-length slots. Host values are
        uploaded; tensors on the device are used as they are."""
        self.decode_calls += 1
        dev = self.device
        logits, self.cache = tr.decode_step(
            self.params, self.cache, torch.as_tensor(tokens, device=dev),
            torch.as_tensor(pos, device=dev), self.cfg,
            rows=torch.as_tensor(members, dtype=torch.long, device=dev),
        )
        return logits

    @staticmethod
    def _scores(rows: torch.Tensor) -> torch.Tensor:
        """(n, V) logits -> (n, 3) fp32: the greedy token, its logit and
        the row's log-sum-exp."""
        rows = rows.float()
        return torch.stack([rows.argmax(-1).float(), rows.amax(-1),
                            torch.logsumexp(rows, -1)], -1)

    @staticmethod
    def _emit(req: Request, score) -> None:
        tok, logit, lse = score
        req.out_tokens.append(int(tok))
        req.out_scores.append((logit, lse))
        if len(req.out_tokens) >= req.max_new_tokens:
            req.done = True  # the prefill's token may meet the budget

    def _prefill_one(self, slot: int, req: Request):
        """Feed the prompt through decode steps (token-by-token prefill;
        simple and cache-layout-identical to decode). Only this slot's
        cache rows are written: other slots may be mid-decode at
        overlapping positions."""
        for t, tok in enumerate(req.prompt):
            tokens = np.zeros((self.slots, 1), np.int32)
            tokens[slot, 0] = tok
            logits = self._step_decode(
                tokens, np.full(self.slots, t, np.int32), [slot]
            )
        self.slot_pos[slot] = len(req.prompt)
        self._emit(req, self._scores(logits[slot:slot + 1, -1]).tolist()[0])

    def _upload(self, host: torch.Tensor) -> torch.Tensor:
        if self.device.type == "cuda":
            return host.to(self.device, non_blocking=True)
        return host.clone()

    def _prefill_whole(self, slot: int, req: Request, k: int) -> torch.Tensor:
        """One prefill of the prompt (staged in row ``k``) into ``slot``'s
        cache rows; the slot's next input token stays on the device.
        Returns the first token's score row (1, 3), unread."""
        s = len(req.prompt)
        self._stage_prompts[k, :s] = torch.from_numpy(
            np.asarray(req.prompt, dtype=np.int32))
        prompt = self._upload(self._stage_prompts[k:k + 1, :s])
        self.prefill_calls += 1
        last = tr.prefill_into(self.params, self.cache, prompt, slot,
                               self.cfg)[:, -1]
        self._next[slot] = last.argmax(-1)
        self.slot_pos[slot] = s
        return self._scores(last)

    def _decode_rows(self) -> None:
        """The whole-prompt decode step over the static buffers: every row
        decodes its next token at its position in ``_pos`` (its cache write
        dropped at ``max_len``), the next tokens stay in ``_next`` and the
        rows' scores go to ``_decoded``. A row at ``max_len`` serves no
        request: it is passed as dead (``live``), so its tokens enter no
        routed expert group."""
        last = tr.decode_step(self.params, self.cache, self._next, self._pos,
                              self.cfg, rows=self._rows,
                              live=self._pos < self.max_len)[0][:, -1]
        self._next.copy_(last.argmax(-1, keepdim=True))
        self._decoded.copy_(self._scores(last))

    @torch.no_grad()
    def _capture(self):
        """The decode step captured as a CUDA graph, after two warm-up
        steps on a side stream; every position is ``max_len``, so neither
        writes the cache."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                self._decode_rows()
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._decode_rows()
        self._next.zero_()
        return graph

    def _decode_whole(self, active: list[int]) -> torch.Tensor:
        """One decode step of the ``active`` slots from their tokens on
        the device; returns every row's score (slots, 3), unread."""
        pos = np.full(self.slots, self.max_len, np.int64)
        pos[active] = self.slot_pos[active]
        self._stage_pos.copy_(torch.from_numpy(pos))
        self._pos.copy_(self._stage_pos, non_blocking=True)
        self.decode_calls += 1
        if self._graph is not None:
            self._graph.replay()
        else:
            self._decode_rows()
        return self._decoded

    @staticmethod
    def _event(timed: bool):
        """A CUDA event recorded now on the current stream (None: untimed)."""
        if not timed:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    @torch.no_grad()
    def step(self) -> int:
        """One engine tick: refill free slots (prefill), one decode step
        for every active slot, the tick's read. Returns the number of
        slots that decoded. No autograd graph is built, and no layer
        body is checkpointed."""
        rec = spans.RECORDER
        on = rec.enabled
        t_step = spans.now() if on else 0
        self.ticks += 1
        tick = self.ticks
        sid = rec.open(t_step) if on else -1
        timed = on and self.device.type == "cuda"
        calls = []  # (name, id, t0, t1, events, attrs before device_ms, after)
        picks, owners = [], []  # unread score rows and each row's (slot, request)
        admitted = 0
        for s in range(self.slots):
            if not self.queue or (self.slot_req[s] is not None
                                  and not self.slot_req[s].done):
                continue
            req = self.queue.pop(0)
            self.slot_req[s] = req
            admitted += 1
            t0, ev = (spans.now() if on else 0), self._event(timed)
            if self.whole:
                picks.append(self._prefill_whole(s, req, len(owners)))
                owners.append((s, req))
            else:
                self._prefill_one(s, req)
            if on:
                calls.append(("lm.prefill", req.uid, t0, spans.now(),
                              (ev, self._event(timed)), (len(req.prompt),), (s,)))
                rec.count(spans.PREFILL_TOKENS, len(req.prompt))
        fresh = {s for s, _ in owners}  # their prefill's token is not read yet
        active = [s for s, req in enumerate(self.slot_req)
                  if req is not None and not req.done
                  and len(req.out_tokens) + (s in fresh) < req.max_new_tokens]
        if active:
            t0, ev = (spans.now() if on else 0), self._event(timed)
            if self.whole:
                picks.append(self._decode_whole(active))
                owners += [(s, self.slot_req[s] if s in active else None)
                           for s in range(self.slots)]
            else:
                tokens = np.zeros((self.slots, 1), np.int32)
                for s in active:
                    tokens[s, 0] = self.slot_req[s].out_tokens[-1]
                logits = self._step_decode(tokens, self.slot_pos.copy(), active)
            if on:
                kv = int(self.slot_pos[active].sum()) + len(active)
                calls.append(("lm.decode", tick, t0, spans.now(),
                              (ev, self._event(timed)), (kv,), tuple(active)))
                rec.count(spans.DECODE_TOKENS, len(active))
        t_pull = spans.now() if on else 0
        if picks:  # the whole-prompt tick's one device read
            for (_, req), score in zip(owners, torch.cat(picks).tolist()):
                if req is not None:  # a row that decoded for no request
                    self._emit(req, score)
        elif active:
            scores = self._scores(logits[:, -1]).tolist()  # one read a tick
            for s in active:
                self._emit(self.slot_req[s], scores[s])
        for s in active:
            self.slot_pos[s] += 1
        if on:
            t = rec.lap("lm.pull", t_pull, tick, sid)
            for name, key, t0, t1, (ev0, ev1), head, tail in calls:
                ms = ev0.elapsed_time(ev1) if ev0 is not None else (t1 - t0) / 1e6
                names = LM_PREFILL_ATTRS if name == "lm.prefill" else LM_DECODE_ATTRS
                rec.add(name, t0, t1, key, sid, (names, *head, ms, *tail))
            rec.add("lm.step", t_step, t, tick, seq=sid,
                    attrs=(LM_STEP_ATTRS, admitted, *active))
        return len(active)

    def run(self) -> list[Request]:
        finished: list[Request] = []
        while self.queue or any(
            r is not None and not r.done for r in self.slot_req
        ):
            self.step()
            for s, r in enumerate(self.slot_req):
                if r is not None and r.done:
                    finished.append(r)
                    self.slot_req[s] = None
        return finished


@dataclasses.dataclass
class VigRequest:
    """One image inference request. ``tenant`` names the stream it belongs
    to (consecutive requests of a tenant share a slot); ``tenant=None``
    marks a one-shot request whose slot is freed after its tick.
    ``tclass`` is the tenant class: the key into a per-class ``slo_ms``
    dict (inert otherwise)."""

    uid: int
    image: np.ndarray  # (H, W, C) float
    tenant: Optional[Any] = None
    logits: Optional[np.ndarray] = None
    done: bool = False
    fault: Optional[FaultInfo] = None  # set when the request was quarantined
    tclass: str = "default"


@dataclasses.dataclass
class _Captured:
    """One cell's forward captured as a CUDA graph, with its static
    buffers: replaying reads ``images`` (and a padded cell's ``mask``)
    and ``state`` and writes ``logits`` and ``new_state``; ``tally`` is the
    kernel launches one replay makes."""

    graph: Any  # torch.cuda.CUDAGraph
    images: torch.Tensor
    state: DigcState
    logits: torch.Tensor
    new_state: DigcState
    tally: dict
    mask: Optional[torch.Tensor] = None

    def replay(self, state: DigcState):
        """Copy the tick's rows into the static inputs (the images and the
        mask are already there), replay, and return the static outputs,
        valid until the next replay."""
        for key, static in self.state.entries.items():
            src = state.entries[key]
            for f in FIELDS:
                dst = getattr(static, f)
                if dst is not None:
                    dst.copy_(getattr(src, f))
        self.graph.replay()
        add_launch_counts(self.tally)
        # A program that passes its state through (a stateless tier)
        # returns the tick's own state, as it does run eagerly.
        return self.logits, (state if self.new_state is self.state
                             else self.new_state)


DEFAULT_BUCKETS = (1, 2, 4, 8)
ROW_COUNTERS = (spans.ROWS_RESET, spans.ROW_INDEX_UPLOADS,
                spans.SCATTER_SKIPPED)
# The attributes of an ``engine.step`` span (``spans.attr_dict``).
STEP_ATTRS = ("bucket", "live", "syncs", "uids")


class VigServeEngine:
    """Bucketed multi-tenant ViG serving on one device.

    ``params`` is the nested parameter dict (``models.convert``); it is
    moved to ``device``. ``device="cuda"`` (the default) raises on a host
    without a card; pass ``device="cpu"`` for the plain PyTorch path.
    ``digc_impl``: a builder name, a DigcSpec, a pre-tuned
    ``VigSchedule`` (applied to every bucket; nothing is tuned), or None
    for ``cfg.digc_impl``. ``buckets``: a tuple, None (one program per
    exact active batch size, ``batch`` slots), or "auto" for the bucket
    set the tuner cache holds for this serving shape (the default ladder
    capped at ``batch`` when it holds none). ``image_sizes``: the lattice's
    image sizes (None: the config's size only, exact shapes). ``bucket_cap``
    caps the programs ``retune_buckets()`` may choose. ``park_capacity``
    bounds the evicted tenants whose state rows are parked (0: an evicted
    tenant returns cold). ``mode`` is "jit" (cell programs, captured on a
    card) or "eager" (the request path raises, as in JAX; ``infer`` on a
    ``supports_cache`` tier runs through the eager ``DigcCache``).

    Admission: ``slo_ms`` (0, a scalar or ``{class: ms}``) arms the
    scheduler, ``clock`` is its time source (None: ``time.monotonic``),
    ``prefetch`` lets it upload parked rows ahead of their tick.

    Faults: ``fault_plan`` arms injection sites; ``guards`` arms the
    screens (finiteness, integrity tokens) and the deadline budget
    ``deadline_ms`` (``deadline_strikes`` consecutive misses descend the
    ladder); a failing build or parking restore is retried
    ``retry_attempts`` times, sleeping ``retry_backoff * 2**attempt``
    seconds between tries.
    """

    def __init__(self, cfg, params: dict, *, digc_impl=None, batch: int = 8,
                 autotune: bool = True, tuner_path=None, mode: str = "jit",
                 buckets=DEFAULT_BUCKETS, image_sizes: Optional[tuple] = None,
                 bucket_cap: int = 4,
                 on_compile: Optional[Callable[[Any], None]] = None,
                 park_capacity: int = 8, fault_plan=None, guards: bool = True,
                 deadline_ms: Optional[float] = None,
                 deadline_strikes: int = 2, retry_attempts: int = 3,
                 retry_backoff: float = 0.02, slo_ms=0.0,
                 clock: Optional[Callable[[], float]] = None,
                 prefetch: bool = True, mesh=None, mesh_axis: str = "data",
                 mesh_batch_axis: Optional[str] = None, device="cuda"):
        if mode not in ("jit", "eager"):
            raise ValueError(f"mode must be 'jit' or 'eager', got {mode!r}")
        self.device = resolve_device(device)
        self.mode = mode
        self.cfg = cfg
        self.batch = int(batch)
        self.autotune = autotune
        self.tuner_path = tuner_path
        self.bucket_cap = int(bucket_cap)
        self.tune_log: list[dict] = []  # DigcTuner.log of every tuning
        auto = isinstance(buckets, str)
        if auto and buckets != "auto":
            raise ValueError(
                f"buckets must be a tuple, None, or 'auto': {buckets!r}")
        if buckets is not None and not auto:
            buckets = tuple(sorted(set(int(b) for b in buckets)))
            if not buckets or buckets[0] < 1:
                raise ValueError(f"buckets must be positive ints: {buckets!r}")
        self.spec = resolve_digc_spec(cfg, digc_impl)
        # The lattice (DESIGN.md §13) is opt-in: without image_sizes the
        # engine serves the config's size with the exact-shape contract.
        # Each size's pyramid is screened here (VigGridError naming the
        # stage and grid), not inside its first tick.
        self._lattice = image_sizes is not None
        if image_sizes is None:
            image_sizes = (cfg.image_size,)
        sizes = tuple(sorted(set(int(s) for s in image_sizes)))
        if not sizes or sizes[0] < cfg.patch:
            raise ValueError(
                f"image_sizes must be >= patch={cfg.patch}: {image_sizes!r}")
        for size in sizes:
            if size % cfg.patch:
                raise ValueError(
                    f"image_sizes: {size} is not divisible by the model "
                    f"patch size {cfg.patch}")
            vig_stage_plans(cfg, digc_impl, grid=size // cfg.patch)
        self.image_sizes = sizes
        if auto:
            buckets = self._auto_bucket_set(self.batch, tuner_path)
        # Mesh-native mode (DESIGN.md §10): the mesh goes into the
        # construction spec, so every cell's program and the slot state
        # see one placement.
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self.mesh_batch_axis = mesh_batch_axis
        if mesh is not None:
            self._check_mesh(digc_impl, buckets)
            self.spec = self.spec.replace(
                mesh=mesh, axis_name=mesh_axis, batch_axis=mesh_batch_axis)
        # Only a user-provided schedule applies to every bucket: one that
        # warmup() tuned is a measurement at self.batch.
        self._user_schedule = isinstance(digc_impl, VigSchedule)
        self.schedule = digc_impl if self._user_schedule else None
        self.tuned = None  # per-stage TuneResults once warmed up
        # direct path: batch size -> [program, DigcState]
        self._direct: dict[int, list] = {}
        self.cache = DigcCache()  # engaged by the eager shim only
        # schedules, programs, captures and staging buffers are keyed by
        # the cell (``_program_key``): the bare bucket on a single-size
        # engine, (size, bucket) on the lattice, (size, bucket, "pad") for
        # a padded cell.
        self._bucket_schedules: dict[Any, VigSchedule] = {}
        self._bucket_tuned: dict[Any, list] = {}
        self.params = _to_device(params, self.device)
        self.buckets = buckets
        self.slots = max(buckets) if buckets is not None else self.batch
        self.on_compile = on_compile
        self.compile_count = 0
        self.requests_served = 0
        self.queue: list[VigRequest] = []
        self.slot_tenant: list[Optional[Any]] = [None] * self.slots
        self._tenant_slot: dict[Any, int] = {}
        self._slot_last_tick = [0] * self.slots
        self._tick = 0
        self._programs: dict[Any, Callable] = {}
        self.bucket_ticks: dict[int, int] = {}
        self.cell_ticks: dict[tuple, int] = {}  # (size, bucket) -> ticks
        self.live_lanes = 0
        self.padded_lanes = 0
        self.lane_hist: dict[tuple, int] = {}  # (image size, live) -> ticks
        self.last_lanes: list[int] = []
        self.last_resets: list[int] = []
        self.last_restores: list[int] = []
        self.last_bucket: Optional[int] = None
        self.last_cell: Optional[tuple] = None  # (size, bucket), last tick
        # The canonical per-slot state of each image size, allocated on
        # its first tick; ``_slot_state`` aliases the first size's.
        self._slot_states: dict[int, DigcState] = {}
        # LRU parking: tenant -> its rows in host memory ({size: rows} on
        # the lattice), oldest first.
        self.park_capacity = int(park_capacity)
        self._parked: dict[Any, Any] = {}
        self.park_hits = 0
        self.park_evictions = 0
        # SLO-bounded admission (DESIGN.md §14).
        self._slo_ms = (dict(slo_ms) if isinstance(slo_ms, dict)
                        else float(slo_ms))
        slo_vals = (self._slo_ms.values() if isinstance(self._slo_ms, dict)
                    else [self._slo_ms])
        if any(float(v) < 0 for v in slo_vals):
            raise ValueError(f"slo_ms must be >= 0: {slo_ms!r}")
        self._sched_active = any(float(v) > 0 for v in slo_vals)
        self._clock = clock
        self._enq_seq = 0  # submit order: the per-tenant FIFO anchor
        self._next_deadline: Optional[float] = None
        self.deferrals = 0  # ticks that waited instead of dispatching
        # Parked rows uploaded ahead of the tick that binds them.
        self._prefetch = bool(prefetch)
        self._park_prefetch: dict[Any, tuple] = {}  # tenant -> (host, dev)
        self.prefetch_issued = 0
        self.prefetch_hits = 0
        # Stale-graph accounting, per (lane, entry), from graph_age deltas.
        self.graph_reuses = 0
        self.graph_rebuilds = 0
        self._drift_sum = 0.0
        self._drift_n = 0
        self.last_drift: dict[str, float] = {}  # entry key -> mean drift
        self.gate_reads = 0  # the reuse gate's device -> host reads
        # CUDA-graph cell programs (on a card): cell -> _Captured, and
        # cell -> (pinned host, device) image and mask buffers.
        self._captured: dict[Any, _Captured] = {}
        self._staging: dict[Any, tuple] = {}
        self._mask_staging: dict[Any, tuple] = {}
        self._graph_stream = None
        # Fault tolerance (DESIGN.md §11).
        self.fault_plan = fault_plan
        self.guards = bool(guards)
        self.deadline_ms = deadline_ms
        self.deadline_strikes = int(deadline_strikes)
        self.retry_attempts = int(retry_attempts)
        self.retry_backoff = float(retry_backoff)
        self.quarantines = 0
        self.state_resets = 0
        self.deadline_misses = 0
        self.park_losses = 0
        self.retries = 0
        self.requests_failed = 0
        self.fallback_level = 0  # rungs descended on the ladder
        self.fault_log: list[FaultInfo] = []  # detected (not injected)
        self.last_quarantined: list[int] = []  # slots, last tick
        # token key (``_token_key``) -> checksum token, and the (size,
        # slot) rows written since their tokens were last taken.
        self._row_tokens: dict[Any, int] = {}
        self._tokens_due: set[tuple] = set()
        self._consecutive_misses = 0
        self._program_ticks: dict[Any, int] = {}  # cell -> ticks served
        # The tick's row index: a pinned host buffer and its device copy
        # (on a card), made on first use, and whether a copy from the
        # host buffer may still be in flight (no host sync since).
        self._rows_host: Optional[torch.Tensor] = None
        self._rows_dev: Optional[torch.Tensor] = None
        self._rows_in_flight = False
        self.row_counts = dict.fromkeys(ROW_COUNTERS, 0)

    # -- the lattice (DESIGN.md §13) --------------------------------------

    @property
    def _slot_state(self) -> Optional[DigcState]:
        """The first image size's canonical slot state (the single-size
        engine's only one)."""
        return self._slot_states.get(self.image_sizes[0])

    @_slot_state.setter
    def _slot_state(self, value: Optional[DigcState]) -> None:
        if value is None:
            self._slot_states.pop(self.image_sizes[0], None)
        else:
            self._slot_states[self.image_sizes[0]] = value

    def _multi_size(self) -> bool:
        return len(self.image_sizes) > 1

    def _req_size(self, req: VigRequest) -> int:
        return getattr(req, "_serve_size", self.image_sizes[0])

    def _req_mask(self, req: VigRequest) -> Optional[np.ndarray]:
        return getattr(req, "_serve_mask", None)

    def _cell_of(self, req: VigRequest) -> tuple:
        """The (size, masked) cell a request resolved to at submit."""
        return (self._req_size(req), self._req_mask(req) is not None)

    def _program_key(self, bucket: int, size: Optional[int] = None,
                     masked: bool = False):
        """The cell's key for programs, captures, ticks and ``on_compile``:
        the bare bucket on a single-size engine, (size, bucket) on the
        lattice, (size, bucket, "pad") for a padded cell."""
        size = self.image_sizes[0] if size is None else size
        if masked:
            return (size, bucket, "pad")
        if not self._multi_size():
            return bucket
        return (size, bucket)

    def _check_mesh(self, digc_impl, buckets) -> None:
        """Refuse a mesh the engine cannot serve, before any slot state
        exists (JAX's messages)."""
        if isinstance(digc_impl, VigSchedule):
            raise ValueError(
                "mesh= applies one placement to every stage; a "
                "pre-tuned VigSchedule carries per-stage specs — "
                "set mesh/axis_name on its stage specs instead")
        if not {"mesh", "axis_name"} <= get_builder(self.spec.impl).knobs:
            raise ValueError(
                f"DIGC impl {self.spec.impl!r} is not mesh-native "
                "(no mesh/axis_name knobs); sharded serving needs "
                "a distributed builder (ring)")
        if self.mesh_batch_axis is None:
            return
        if buckets is None:
            # The exact-size policy serves every count 1..slots, most of
            # which cannot divide a sharded batch axis.
            raise ValueError(
                "mesh_batch_axis requires a bucket set: the exact-size "
                "policy (buckets=None) serves arbitrary batch sizes, which "
                "cannot all divide a sharded batch axis")
        dsz = int(self.mesh.shape[self.mesh_batch_axis])
        bad = [v for v in buckets if v < dsz]
        if bad:
            # A bucket below the axis cannot give every rank a live row;
            # a bucket that merely does not divide it pads per tick.
            raise ValueError(
                f"bucket sizes {bad} are smaller than the "
                f"{self.mesh_batch_axis!r} mesh axis ({dsz} devices); "
                "configure buckets >= the axis size (non-dividing buckets "
                "are padded per tick)")

    def _tick_width(self, bucket: int) -> int:
        """The batch width of a tick's program: the bucket, padded up to
        the next ``mesh_batch_axis`` multiple when the rows are sharded
        data-parallel (padding lanes replicate lane 0)."""
        if self.mesh is None or self.mesh_batch_axis is None:
            return bucket
        dsz = int(self.mesh.shape[self.mesh_batch_axis])
        return -(-bucket // dsz) * dsz

    def _token_key(self, size: int, slot: int):
        """Integrity tokens are per (size, slot): the bare slot on a
        single-size engine, "{size}:{slot}" on the lattice."""
        return slot if not self._multi_size() else f"{size}:{slot}"

    # -- tuning ---------------------------------------------------------

    def _tuner(self) -> DigcTuner:
        tuner = DigcTuner(self.tuner_path, device=self.device)
        tuner.log = self.tune_log
        return tuner

    def _stage_rows(self, size: Optional[int] = None) -> list[dict]:
        """One workload row per stage at ``size`` (default: the native
        size): pooled stages tune their real (N, M) pair, later pyramid
        stages their own, so a tuner key covers both lattice dimensions."""
        grid = None if size is None else size // self.cfg.patch
        rows: dict[int, dict] = {}
        for row in count_digc_work(self.cfg, grid=grid):
            rows.setdefault(row["stage"], row)
        return [rows[si] for si in sorted(rows)]

    def _tunes(self) -> bool:
        return self.autotune and self.spec.impl == "blocked"

    def warmup(self, rng_seed: int = 0):
        """Tune a per-stage schedule at ``batch`` for the direct path
        (blocked tier only). The request path tunes per cell, on a cell's
        first tick. A no-op when a ``VigSchedule`` was given at
        construction or one is already tuned."""
        if not self._tunes() or self.schedule is not None:
            return None
        self.schedule, self.tuned = self._tuner().tune_schedule(
            self._stage_rows(), spec=self.spec, batch=self.batch,
            rng_seed=rng_seed,
        )
        # Programs prepared before the schedule existed carry the old
        # spec: drop them so the next call prepares one with it.
        self._direct.clear()
        return self.tuned

    def _impl_choice(self):
        return self.schedule if self.schedule is not None else self.spec

    def _bucket_choice(self, bucket: int, size: Optional[int] = None):
        """The DIGC spec or schedule of one (B, N) cell's program. The
        tuner's workload key holds the batch size and the node counts
        (``_stage_rows(size)``), so each cell has its own schedule (never
        warmup()'s, measured at ``batch``); a user-provided schedule
        applies everywhere. The first miss at a size tunes every
        configured bucket there at once: a serving replica prepares them
        all anyway, and the cache makes later engines free."""
        if self._user_schedule:
            return self.schedule
        if not self._tunes():
            return self.spec
        size = self.image_sizes[0] if size is None else size
        skey = bucket if not self._multi_size() else (size, bucket)
        if skey not in self._bucket_schedules:
            targets = {bucket} | set(self.buckets or ())
            schedules, tuned = self._tuner().tune_bucket_schedules(
                self._stage_rows(size), spec=self.spec,
                buckets=sorted(targets))
            for b in schedules:
                key = b if not self._multi_size() else (size, b)
                self._bucket_schedules[key] = schedules[b]
                self._bucket_tuned[key] = tuned[b]
        return self._bucket_schedules[skey]

    def retune_buckets(self, max_programs: Optional[int] = None,
                       force: bool = True) -> tuple:
        """Re-derive the bucket set from the live-lane histogram of the
        served trace (``lane_hist``) with ``core.tuner.optimal_bucket_set``,
        each size weighted by its cost (size / patch)^2, persisted per host
        in the tuner cache, so the next engine built with
        ``buckets="auto"`` and the same cache starts on it. Takes effect
        live: dropped buckets keep their programs but are never picked
        again; new ones are prepared on first use."""
        hist: dict[int, dict[int, int]] = {}
        for (sz, live), ticks in self.lane_hist.items():
            per = hist.setdefault(sz, {})
            per[live] = per.get(live, 0) + ticks
        cap = self.bucket_cap if max_programs is None else int(max_programs)
        costs = {s: (s // self.cfg.patch) ** 2 for s in self.image_sizes}
        if self.tuner_path is not None:
            new = self._tuner().tune_bucket_set(
                hist, slots=self.slots, max_programs=cap, costs=costs,
                sizes=self.image_sizes, force=force)
        else:
            new = optimal_bucket_set(hist, slots=self.slots,
                                     max_programs=cap, costs=costs)
        self.buckets = new
        return new

    def _auto_bucket_set(self, slots: int, tuner_path) -> tuple:
        """``buckets="auto"``: the persisted bucket set of this (slots,
        sizes, cap) serving shape when the tuner cache holds one, else
        the default ladder capped at ``slots``."""
        if tuner_path is not None:
            found = self._tuner().lookup_bucket_set(
                slots=slots, sizes=self.image_sizes,
                max_programs=self.bucket_cap)
            if found is not None:
                return found
        return tuple(b for b in DEFAULT_BUCKETS if b < slots) + (slots,)

    # -- direct fixed-batch path ----------------------------------------

    def infer(self, images) -> torch.Tensor:
        """images (B, H, W, C) -> logits (B, num_classes) on the device.
        With tuning on, the first call tunes the schedule (``warmup``)."""
        if self._tunes() and self.tuned is None and self.schedule is None:
            self.warmup()
        imgs = torch.as_tensor(images, dtype=torch.float32).to(self.device)
        b = int(imgs.shape[0])
        if self.mode == "eager" and get_builder(self.spec.impl).supports_cache:
            # The legacy shim: the host-side cache carries the warm starts
            # across layers and calls.
            with torch.inference_mode():
                logits = vig_forward(self.params, imgs, self.cfg,
                                     digc_impl=self.spec, cache=self.cache)
            self.requests_served += b
            return logits
        if b not in self._direct:
            choice = self._impl_choice()
            self._direct[b] = [self._forward(choice), init_vig_state(
                self.cfg, b, choice, device=self.device)]
        program, state = self._direct[b]
        logits, self._direct[b][1] = program(imgs, state)
        self.requests_served += b
        return logits

    # -- multi-tenant request path --------------------------------------

    def submit(self, req: VigRequest) -> None:
        """Enqueue a request. A malformed image fails here, at the
        submitter, with an error naming the field. On the lattice an
        image of a configured size serves its own cell unmasked, and a
        ragged one is padded up to the smallest size that fits with a
        live-node mask. Records an ``engine.submit`` span (id: the uid)."""
        rec = spans.RECORDER
        t0 = spans.now() if rec.enabled else 0
        req._serve_size, req._serve_mask = self._serve_cell(req)
        self._enqueue(req)
        if rec.enabled:
            rec.lap("engine.submit", t0, req.uid)

    def _serve_cell(self, req: VigRequest) -> tuple:
        """The (image size, live-node mask or None) a request serves at;
        raises on a malformed image."""
        img = np.asarray(req.image)
        if not self._lattice:
            want = (self.cfg.image_size, self.cfg.image_size,
                    self.cfg.in_chans)
            if img.shape != want:
                raise ValueError(
                    f"VigRequest.image (uid={req.uid}): shape {img.shape} "
                    f"does not match the engine config {want} (image_size, "
                    "image_size, in_chans)"
                )
            _check_float(req, img)
            return self.image_sizes[0], None
        if img.ndim != 3:
            raise ValueError(
                f"VigRequest.image (uid={req.uid}): expected a 3-d "
                f"(H, W, C) array, got ndim={img.ndim} shape={img.shape}"
            )
        h, w, c = img.shape
        if c != self.cfg.in_chans:
            raise ValueError(
                f"VigRequest.image (uid={req.uid}): {c} channels does "
                f"not match the engine config in_chans={self.cfg.in_chans}"
            )
        if h != w:
            raise ValueError(
                f"VigRequest.image (uid={req.uid}): non-square image "
                f"{img.shape}; the patch lattice needs H == W"
            )
        _check_float(req, img)
        if h in self.image_sizes:
            return h, None
        if h % self.cfg.patch:
            raise ValueError(
                f"VigRequest.image (uid={req.uid}): size {h} is not "
                f"divisible by the model patch size {self.cfg.patch}"
            )
        fits = [s for s in self.image_sizes if s >= h]
        if not fits:
            raise ValueError(
                f"VigRequest.image (uid={req.uid}): size {h} exceeds "
                f"the largest configured image size "
                f"{self.image_sizes[-1]} (image_sizes={self.image_sizes})"
            )
        size = fits[0]
        self._check_pad_capable(req, h)
        g, g0 = size // self.cfg.patch, h // self.cfg.patch
        mask2d = np.zeros((g, g), bool)
        mask2d[:g0, :g0] = True
        return size, mask2d.reshape(-1)

    def _check_pad_capable(self, req: VigRequest, h: int) -> None:
        """Pad nodes need a single-stage r = 1 model (pooling and
        downsampling would mix pad and live rows) and a pad-capable DIGC
        tier (``GraphBuilder.supports_pad``)."""
        cfg = self.cfg
        if len(cfg.depths) > 1 or any(
                r > 1 for r in cfg.reduce_ratios[:len(cfg.depths)]):
            raise ValueError(
                f"VigRequest.image (uid={req.uid}): size {h} needs "
                f"pad nodes to reach the {self.image_sizes} cell set, "
                f"but model {cfg.name!r} has a multi-stage/pooled "
                f"pyramid (depths={cfg.depths}, "
                f"reduce_ratios={cfg.reduce_ratios}) that would mix pad "
                "and live rows — submit an exact configured size, or "
                "add this size to image_sizes"
            )
        impl = (self.schedule.spec_for(0).impl if self._user_schedule
                else self.spec.impl)
        if not get_builder(impl).supports_pad:
            raise ValueError(
                f"VigRequest.image (uid={req.uid}): size {h} needs pad "
                f"nodes, but DIGC impl {impl!r} does not support "
                "pad-node masking (m_valid); submit an exact configured "
                "size, or serve a pad-capable tier"
            )

    # -- SLO-bounded admission (DESIGN.md §14) ----------------------------

    def _now(self) -> float:
        """Scheduler time: the injected clock (a ``VirtualClock`` or any
        zero-argument callable) or ``time.monotonic``."""
        if self._clock is None:
            return time.monotonic()
        now = getattr(self._clock, "now", None)
        return now() if now is not None else self._clock()

    def _slo_s(self, req: VigRequest) -> float:
        """The request's admission budget in seconds: its class's entry of
        a dict ``slo_ms`` (else "default", else 0: dispatch now), or the
        scalar."""
        if isinstance(self._slo_ms, dict):
            ms = self._slo_ms.get(req.tclass, self._slo_ms.get("default", 0.0))
        else:
            ms = self._slo_ms
        return float(ms) / 1e3

    def _tkey(self, req: VigRequest):
        return req.tenant if req.tenant is not None else ("req", req.uid)

    def _enqueue(self, req: VigRequest) -> None:
        """Queue a validated request, stamped with its arrival time and
        submit order (the deadline and FIFO anchors), and let the parking
        prefetcher look at the new queue."""
        req._enq_t = self._now()
        req._enq_seq = self._enq_seq
        self._enq_seq += 1
        self.queue.append(req)
        self._prefetch_parked()

    def _select_cell(self, peek: bool = False):
        """The (size, masked) cell the next tick serves and its eligible
        requests, or (None, None) to defer.

        With the scheduler off: the head of the queue's cell and every
        queued request of that cell. With it on, each request has a
        deadline (arrival + its class budget); a tenant's effective
        deadline is the least over its queued requests, carried by its
        head request. A cell is ripe when its earliest deadline has come
        or it holds a full slot width of tenants; the ripe cell with the
        earliest (deadline, submit order) dispatches, and only tenants'
        head requests are eligible, so each tenant is served in order.
        With no ripe cell the tick defers and ``_next_deadline`` records
        when the first cell ripens. ``peek=True`` never defers: it names
        the cell that will dispatch next (what the prefetcher uploads)."""
        if not self.queue:
            return None, None
        if not self._sched_active:
            cell = self._cell_of(self.queue[0])
            return cell, [r for r in self.queue if self._cell_of(r) == cell]
        heads: dict[Any, VigRequest] = {}
        eff: dict[Any, float] = {}
        for r in self.queue:
            tk = self._tkey(r)
            heads.setdefault(tk, r)
            dl = r._enq_t + self._slo_s(r)
            eff[tk] = min(eff.get(tk, dl), dl)
        cells: dict[tuple, list] = {}  # cell -> [deadline, tenants, seq]
        for tk, head in heads.items():
            info = cells.setdefault(self._cell_of(head),
                                    [float("inf"), 0, head._enq_seq])
            info[0] = min(info[0], eff[tk])
            info[1] += 1
            info[2] = min(info[2], head._enq_seq)
        now = self._now()
        ripe = [c for c, (dl, nt, _) in cells.items()
                if now >= dl - 1e-9 or nt >= self.slots]
        if not ripe:
            if not peek:
                self._next_deadline = min(i[0] for i in cells.values())
                return None, None
            ripe = list(cells)
        cell = min(ripe, key=lambda c: (cells[c][0], cells[c][2]))
        head_ids = {id(r) for r in heads.values()}
        eligible = [r for r in self.queue
                    if id(r) in head_ids and self._cell_of(r) == cell]
        if not peek:
            self._next_deadline = None
        return cell, eligible

    def next_deadline(self) -> Optional[float]:
        """The earliest admission deadline among queued requests, or None
        (empty queue, or the scheduler off): a serving loop wakes then
        even with no new arrival (``serve.sched.replay`` does)."""
        if not self._sched_active or not self.queue:
            return None
        return min(r._enq_t + self._slo_s(r) for r in self.queue)

    def _advance_to_deadline(self) -> None:
        """After a deferred tick, move time to the recorded deadline: a
        clock with ``advance_to`` (``VirtualClock``) jumps; the wall clock
        sleeps the rest."""
        target = self._next_deadline
        if target is None:
            return
        adv = getattr(self._clock, "advance_to", None)
        if adv is not None:
            adv(target)
            return
        delta = target - self._now()
        if delta > 0:
            time.sleep(min(delta, 60.0))

    def _prefetch_parked(self) -> None:
        """Start the next tick's parking restores now: a parked, unslotted
        tenant among the requests the queue names for the next tick gets
        its rows uploaded (``prefetch_park_rows``: from pinned memory,
        without blocking, on a card). A placement hint only: ``_unpark``
        still passes the ``park.restore`` fault site and the screens, and
        binds the uploaded copy only when the restored host object is the
        one it was uploaded from."""
        if not self._prefetch or not self._parked or not self.queue:
            return
        _, eligible = self._select_cell(peek=True)
        for req in (eligible or [])[:self.slots]:
            tk = self._tkey(req)
            if (tk in self._parked and tk not in self._tenant_slot
                    and tk not in self._park_prefetch):
                host = self._parked[tk]
                self._park_prefetch[tk] = (
                    host, prefetch_park_rows(host, self.device))
                self.prefetch_issued += 1

    # -- programs -------------------------------------------------------

    def bucket_for(self, active: int) -> int:
        """Smallest bucket that fits ``active`` slots; the count itself
        under the exact-size policy."""
        if not 1 <= active <= self.slots:
            raise ValueError(f"active={active} outside 1..{self.slots}")
        if self.buckets is None:
            return active
        return next(b for b in self.buckets if b >= active)

    def _forward(self, choice, masked: bool = False) -> Callable:
        """A prepared forward through the DIGC spec or schedule ``choice``:
        (images (B, H, W, C), state) -> (logits, new state), or with
        ``masked`` (images, mask (B, N) bool, state)."""
        params, cfg = self.params, self.cfg

        if masked:
            def program(images: torch.Tensor, mask: torch.Tensor,
                        state: DigcState):
                with torch.inference_mode():
                    return vig_forward(params, images, cfg, digc_impl=choice,
                                       state=state, valid_mask=mask)
        else:
            def program(images: torch.Tensor, state: DigcState):
                with torch.inference_mode():
                    return vig_forward(params, images, cfg, digc_impl=choice,
                                       state=state)

        return program

    def _choice_for(self, bucket: int, size: Optional[int] = None):
        """The cell's DIGC spec or schedule through the degradation
        ladder: the tuned per-cell choice at level 0, else the next tier
        of ``fallback_chain`` with the common spec fields only."""
        if self.fallback_level == 0:
            return self._bucket_choice(bucket, size)
        chain = fallback_chain(self._ladder_base_impl())
        return degraded_spec(self.spec, chain[self.fallback_level - 1])

    def _ladder_base_impl(self) -> str:
        return _stage0_impl(self._impl_choice())

    def _build_program(self, bucket: int, size: Optional[int] = None,
                       masked: bool = False) -> Callable:
        """One cell's program: (images (bucket, H, W, C)[, mask], state)
        -> (logits, new state). Passes the ``program.build`` fault site."""
        choice = self._choice_for(bucket, size)
        self._fire("program.build", bucket=bucket, impl=_stage0_impl(choice))
        return self._forward(choice, masked)

    def _program_for(self, bucket: int, size: Optional[int] = None,
                     masked: bool = False) -> Callable:
        """Program lookup with recovery: a failing build is retried, and a
        tier that keeps failing walks the degradation ladder until a rung
        builds; an exhausted ladder re-raises. The tuned choice is
        resolved first, outside the retry and the ladder (where JAX tunes
        inside its build)."""
        key = self._program_key(bucket, size, masked)
        single = key == bucket  # the one-argument build of a single size
        while key not in self._programs:
            if self.fallback_level == 0:
                # Tuning builds and times the kernels on the card: a
                # kernel that fails there raises out of step(), never
                # into the ladder below (the ladder steps down tiers, it
                # does not stand in for a broken kernel).
                self._bucket_choice(bucket, size)
            try:
                prog = self._retry(
                    (lambda: self._build_program(bucket)) if single else
                    (lambda: self._build_program(bucket, size=size,
                                                 masked=masked)))
            except Exception as e:  # noqa: BLE001 (the ladder's boundary)
                info = (e.info if isinstance(e, FaultError) else FaultInfo(
                    kind="compile_failure", site="program.build",
                    tick=self._tick, detail=repr(e),
                ))
                if not self._degrade(dataclasses.replace(
                        info, kind="compile_degrade",
                        detail=f"{info.detail}; descending ladder")):
                    raise
                continue
            self._programs[key] = prog
            if not self._captures():
                self._count_compile(key)
        return self._programs[key]

    def _count_compile(self, key) -> None:
        self.compile_count += 1
        if self.on_compile is not None:
            self.on_compile(key)

    # -- CUDA-graph cell programs ---------------------------------------

    def _captures(self) -> bool:
        """Cell programs are captured as CUDA graphs on a card; on the CPU
        there is nothing to capture and they run eagerly."""
        return self.device.type == "cuda"

    def _upload(self, key, imgs: list, masks: Optional[list] = None):
        """The tick's batch (B, H, W, C) and, for a padded cell, its live
        mask (B, N) on the device. On a card each is stacked into the
        cell's pinned staging buffer and copied without blocking into its
        device buffer, the captured program's static input: ticks of two
        ragged sizes share a padded cell, so the mask is an input too."""
        if self.device.type != "cuda":
            mask = None if masks is None else torch.from_numpy(np.stack(masks))
            return torch.from_numpy(np.stack(imgs)), mask
        images = self._stage(self._staging, key, imgs, torch.float32)
        mask = (None if masks is None else
                self._stage(self._mask_staging, key, masks, torch.bool))
        return images, mask

    def _stage(self, buffers: dict, key, rows: list, dtype) -> torch.Tensor:
        if key not in buffers:
            shape = (len(rows),) + rows[0].shape
            buffers[key] = (
                torch.empty(shape, dtype=dtype, pin_memory=True),
                torch.empty(shape, dtype=dtype, device=self.device))
        host, dev = buffers[key]
        np.stack(rows, out=host.numpy())
        dev.copy_(host, non_blocking=True)
        return dev

    def _serve(self, key, program: Callable, images: torch.Tensor,
               bucket_state: DigcState, mask: Optional[torch.Tensor] = None):
        """Run the cell's program: eagerly on the CPU; on a card, replay
        its captured graph, or on its first tick serve it eagerly on the
        capture stream (the capture's warm-up: cuBLAS handles, the kernel
        library, the kernels' shared-memory attributes) and capture it
        there from ``images``, ``mask`` and ``bucket_state`` as static
        inputs."""
        args = ((images, bucket_state) if mask is None
                else (images, mask, bucket_state))
        if not self._captures():
            return program(*args)
        cap = self._captured.get(key)
        if cap is not None:
            return cap.replay(bucket_state)
        if self._graph_stream is None:
            self._graph_stream = torch.cuda.Stream(self.device)
        side = self._graph_stream
        current = torch.cuda.current_stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = program(*args)
        graph = torch.cuda.CUDAGraph()
        with uncounted_launches() as tally:
            with torch.cuda.graph(graph, stream=side):
                logits, new_state = program(*args)
        current.wait_stream(side)
        self._captured[key] = _Captured(
            graph=graph, images=images, state=bucket_state, logits=logits,
            new_state=new_state, tally=tally, mask=mask)
        self._count_compile(key)
        return out

    # -- slot state -----------------------------------------------------

    def _ensure_slot_state(self, size: Optional[int] = None) -> DigcState:
        """The canonical per-slot state of ``size`` (default: the first
        size), sized by that size's stage plans and allocated from the
        choice the programs resolve: a user-provided schedule's per-stage
        specs, else the engine spec (tuned schedules change no entry
        shape)."""
        size = self.image_sizes[0] if size is None else size
        if size not in self._slot_states:
            choice = self.schedule if self._user_schedule else self.spec
            self._slot_states[size] = init_vig_state(
                self.cfg, self.slots, choice, per_slot=True,
                mesh=self.mesh, mesh_axis=self.mesh_axis,
                grid=size // self.cfg.patch, device=self.device)
        return self._slot_states[size]

    def _slot_index(self, slot: int) -> torch.Tensor:
        """One slot's row index, made on the device (a fill: no host copy
        and no wait), for the resets and restores off a tick's staged
        index."""
        return torch.full((1,), slot, dtype=torch.long, device=self.device)

    def _reset_slot(self, slot: int) -> None:
        """Cold-reset ``slot``'s rows at every allocated size (a slot's
        occupant changes for every resolution at once); their tokens fall
        due."""
        index = self._slot_index(slot)
        for size, st in self._slot_states.items():
            self._slot_states[size] = st.reset_rows_at(index)
        self._refresh_tokens([slot])

    def release(self, tenant: Any) -> None:
        """Tenant disconnect: free its slot and cold-reset the rows, so the
        next occupant cannot warm-start from them. Its parked copy (if
        any) goes too: a disconnect, unlike an eviction, does not park."""
        self._parked.pop(tenant, None)
        self._park_prefetch.pop(tenant, None)
        slot = self._tenant_slot.pop(tenant, None)
        if slot is None:
            return
        self.slot_tenant[slot] = None
        if self._slot_states:
            self._reset_slot(slot)

    def _park(self, tenant: Any, slot: int) -> None:
        """Copy an evicted tenant's rows at every allocated size to host
        memory (pinned on a card) so a later re-admit restores them warm;
        beyond ``park_capacity`` the oldest parked copy is dropped. The
        lattice parks ``{size: rows}``, a single-size engine the rows."""
        if self.park_capacity <= 0 or not self._slot_states:
            return
        pin = self.device.type == "cuda"
        host = {size: st.take_rows([slot]).to("cpu", pin=pin)
                for size, st in self._slot_states.items()}
        if pin:
            _count_sync(None, len(host))
        self._parked.pop(tenant, None)  # re-insert = most recent
        self._park_prefetch.pop(tenant, None)  # an upload of older rows
        self._parked[tenant] = (host if self._multi_size()
                                else host[self.image_sizes[0]])
        while len(self._parked) > self.park_capacity:
            oldest = next(iter(self._parked))
            del self._parked[oldest]
            self._park_prefetch.pop(oldest, None)
            self.park_evictions += 1

    def _unpark(self, tenant: Any, slot: int) -> bool:
        """Restore a parked tenant's rows into its new slot; False (the
        caller cold-resets) when nothing is parked. Only row fields are
        restored: ``step`` stays the canonical entry's. Sizes allocated
        since the park are reset (the copy holds no rows for them).

        The restore passes the ``park.restore`` fault site: a transient
        error is retried with backoff; ``None`` where a parked copy
        existed is a parking-store loss, counted, and the tenant
        re-admits cold. An upload the prefetcher made of the same host
        rows is bound in place of a new copy."""
        had_copy = tenant in self._parked
        host = self._parked.pop(tenant, None)
        prefetched = self._park_prefetch.pop(tenant, None)
        orig = host
        if host is not None:
            try:
                host = self._retry(lambda: self._fire(
                    "park.restore", value=host, tenant=tenant))
            except FaultError:
                host = None
        if host is None:
            if had_copy:
                self.park_losses += 1
                self.state_resets += 1  # the caller's cold reset
                self.fault_log.append(FaultInfo(
                    kind="parking_loss", site="park.restore", tenant=tenant,
                    tick=self._tick,
                    detail="parked rows unrecoverable; re-admitting cold"))
            return False
        if prefetched is not None and host is orig:
            host = prefetched[1]
            self.prefetch_hits += 1
        per_size = host if self._multi_size() else {self.image_sizes[0]: host}
        index = self._slot_index(slot)
        for size, st in self._slot_states.items():
            if size not in per_size:
                self._slot_states[size] = st.reset_rows_at(index)
        for size, rows in per_size.items():
            state = self._ensure_slot_state(size)
            self._slot_states[size] = DigcState(entries={
                k: dataclasses.replace(e.put_rows(rows.entries[k], index),
                                       step=e.step)
                for k, e in state.entries.items()
            })
        self.park_hits += 1
        self._refresh_tokens([slot])
        return True

    def _admit(self, tenant_key, used: set) -> Optional[int]:
        """Bind a new tenant to a free slot, else the least recently used
        slot not serving this tick (its tenant's rows are parked first);
        None when every slot is busy. The slot's rows are restored from
        the tenant's parked copy at once, else the slot joins
        ``last_resets``, which the tick cold-resets in one batch after
        admission (``_reset_cold``): a later eviction in the same tick
        parks another slot, whose rows no reset has touched."""
        free = [s for s in range(self.slots)
                if self.slot_tenant[s] is None and s not in used]
        if free:
            slot = free[0]
        else:
            idle = [s for s in range(self.slots) if s not in used]
            if not idle:
                return None
            slot = min(idle, key=lambda s: self._slot_last_tick[s])
            evicted = self.slot_tenant[slot]
            del self._tenant_slot[evicted]
            self._park(evicted, slot)
        self.slot_tenant[slot] = tenant_key
        self._tenant_slot[tenant_key] = slot
        if self._unpark(tenant_key, slot):
            self.last_restores.append(slot)
        else:
            self._refresh_tokens([slot])
            self.last_resets.append(slot)
        return slot

    # -- fault tolerance (DESIGN.md §11) --------------------------------

    def _fire(self, site: str, value=None, **ctx):
        """Fault-injection hook: returns ``value`` unchanged unless a
        ``FaultPlan`` was given."""
        if self.fault_plan is None:
            return value
        return self.fault_plan.fire(site, value=value, tick=self._tick, **ctx)

    def _retry(self, fn):
        """Bounded retry with exponential backoff for host-side transients
        (parking restore, program build); re-raises the last error once
        the budget is spent."""
        last = None
        for attempt in range(self.retry_attempts):
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 (the transient boundary)
                last = e
                self.retries += 1
                if attempt + 1 < self.retry_attempts:
                    time.sleep(self.retry_backoff * (2 ** attempt))
        raise last

    def _refresh_tokens(self, slots, size: Optional[int] = None) -> None:
        """Mark ``slots``' rows at ``size`` (default: every allocated size)
        as written by the engine (admission reset, restore, quarantine,
        corruption recovery): their integrity tokens are re-taken at the
        next flush, which comes before any screen reads them, so a later
        mismatch is an unsanctioned mutation."""
        if self.guards:
            sizes = self._slot_states if size is None else (size,)
            self._tokens_due.update((sz, s) for sz in sizes for s in slots)

    def _due(self, size: int) -> list:
        return sorted(s for sz, s in self._tokens_due if sz == size)

    def _flush_tokens(self, size: int) -> None:
        """Re-take now the tokens of ``size``'s rows written since the
        last flush: one device -> host pull."""
        due = self._due(size)
        if due and size in self._slot_states:
            sums = self._slot_states[size].row_checks()[1]
            self._adopt_tokens(size, due, sums.cpu())
            _count_sync(sums)

    def _adopt_tokens(self, size: int, slots: list, sums: torch.Tensor) -> None:
        """Take ``slots``' checksums at ``size`` from ``sums`` (every
        row's, on the host) as their integrity tokens."""
        for slot in slots:
            self._row_tokens[self._token_key(size, slot)] = int(sums[slot])
            self._tokens_due.discard((size, slot))

    def _screen(self, images: torch.Tensor, size: int) -> tuple:
        """Queue the screen of the picked lanes' images (their upload,
        ``images``) and of every slot's rows at ``size`` on the device, and
        their copies to the host; returns the host tensors and an event
        that marks them ready."""
        finite, sums = self._slot_states[size].row_checks()
        img_ok = torch.isfinite(images.reshape(images.shape[0], -1)).all(dim=1)
        host = [None if t is None else _to_host_async(t)
                for t in (img_ok, finite, sums)]
        ready = None
        if images.is_cuda:
            ready = torch.cuda.Event()
            ready.record()
        return (*host, ready)

    def _screened(self, picked: list, size: int, img_ok, finite,
                  sums) -> tuple:
        """The screen's verdicts, once its copies are on the host
        (``step`` waits on its event): quarantine a lane whose
        image or state rows are not finite, serve cold (reset at ``size``)
        a lane whose rows' checksum no longer matches its token (rows
        never tokened are trusted, and rows the engine wrote since, take
        theirs now). Returns the healthy lanes' indices in ``picked`` and
        whether a healthy lane's rows were reset."""
        keep, reset = [], False
        for i, (slot, req) in enumerate(picked):
            if not img_ok[i]:
                self._quarantine(slot, req, FaultInfo(
                    kind="nonfinite_input", site="admit.image",
                    tenant=req.tenant, tick=self._tick,
                    detail="non-finite values in submitted image"))
                continue
            if finite is not None and not finite[slot]:
                # The warm carry is poisoned: fail the request and
                # cold-reset the slot.
                self._quarantine(slot, req, FaultInfo(
                    kind="nonfinite_state", site="state.rows",
                    tenant=req.tenant, tick=self._tick,
                    detail=f"non-finite state rows on slot {slot}"))
                continue
            token = int(sums[slot])
            tk = self._token_key(size, slot)
            if (size, slot) in self._tokens_due or tk not in self._row_tokens:
                self._adopt_tokens(size, [slot], sums)
            elif self._row_tokens[tk] != token:
                # Finite but token-mismatched rows (silent corruption):
                # serve this request cold.
                self._slot_states[size] = self._slot_states[
                    size].reset_rows_at(self._slot_index(slot))
                self._refresh_tokens([slot], size)
                self.state_resets += 1
                self.fault_log.append(FaultInfo(
                    kind="state_corruption", site="state.rows",
                    tenant=req.tenant, tick=self._tick,
                    detail=(f"integrity token mismatch on slot {slot}; "
                            "cold reset")))
                self.last_resets.append(slot)
                reset = True
            keep.append(i)
        return keep, reset

    def _quarantine(self, slot: int, req: VigRequest,
                    info: FaultInfo) -> None:
        """Fail one request with a typed ``FaultInfo`` and cold-reset its
        slot at every size; co-batched tenants are untouched (the lane
        never reaches the program)."""
        req.fault = info
        req.logits = None
        req.done = True
        self.quarantines += 1
        self.requests_failed += 1
        self.fault_log.append(info)
        self.last_quarantined.append(slot)
        if self._slot_states:
            self._reset_slot(slot)
            self.state_resets += 1
        self._slot_last_tick[slot] = self._tick
        if req.tenant is None:
            self.slot_tenant[slot] = None
            self._tenant_slot.pop(("req", req.uid), None)

    def _degrade(self, info: FaultInfo) -> bool:
        """Descend one rung of the degradation ladder: drop every program,
        with its captured graph, static buffers and memory pool, so the
        next tick builds at the next-simpler tier. False when the ladder
        is exhausted."""
        chain = fallback_chain(self._ladder_base_impl())
        if self.fallback_level >= len(chain):
            return False
        self.fallback_level += 1
        self._programs.clear()
        self._captured.clear()
        self._program_ticks.clear()
        self._consecutive_misses = 0
        self.fault_log.append(info)
        return True

    def _graph_stats_update(self, old: DigcState, new: DigcState,
                            lanes: list) -> None:
        """Per-lane graph reuse / rebuild counts from one tick's state
        delta: the gate resets a row's ``graph_age`` to 0 when it rebuilt
        and grows it otherwise. Drift is the relative change of the
        snapshot statistic on rebuilt warm lanes (cold lanes carry the
        zero snapshot: their first build is an admission, not drift)."""
        rows = torch.as_tensor(lanes, dtype=torch.long)
        for key, new_e in new.entries.items():
            old_e = old.entries.get(key)
            if new_e.graph_age is None or old_e is None or old_e.graph_age is None:
                continue
            rebuilt = new_e.graph_age.cpu()[rows] == 0
            _count_sync(new_e.graph_age, 3)  # the ages and both snapshots
            self.graph_rebuilds += int(rebuilt.sum())
            self.graph_reuses += int((~rebuilt).sum())
            old_snap = old_e.graph_snap.cpu()[rows]
            new_snap = new_e.graph_snap.cpu()[rows]
            warm = old_snap.abs() > 0
            drift = ((new_snap - old_snap).abs()
                     / old_snap.abs().clamp_min(1e-9))[warm]
            if drift.numel():
                self.last_drift[key] = float(drift.mean())
                self._drift_sum += float(drift.sum())
                self._drift_n += int(drift.numel())

    # -- the tick -------------------------------------------------------

    def _count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the row counter ``name`` (``stats()``) and, on a
        card, to the recorder's (which, as for ``engine.syncs``, counts
        what the card was asked to do)."""
        self.row_counts[name] += n
        rec = spans.RECORDER
        if rec.enabled and self.device.type == "cuda":
            rec.count(name, n)

    def _row_index(self, lanes: list, resets: list = ()) -> tuple:
        """The tick's row indices on the device, from one host -> device
        copy: ``lanes`` padded to the tick's width by replicating lane 0
        (the rows the program serves), then ``resets`` (the slots to
        cold-reset). On a card the ids go through one pinned buffer,
        allocated once, and are copied without waiting; the buffer is
        rewritten only once a host sync has ordered past its last copy
        (the screen's event or the last tick's logits pull; a tick that
        raised before either leaves the stream to be synchronized
        here)."""
        pad = self._tick_width(self.bucket_for(len(lanes))) - len(lanes)
        ids = lanes + [lanes[0]] * pad + list(resets)
        n = len(ids) - len(resets)
        self._count(spans.ROW_INDEX_UPLOADS)
        if self.device.type != "cuda":
            index = torch.tensor(ids, dtype=torch.long, device=self.device)
            return index[:n], index[n:]
        if self._rows_host is None:
            cap = self._tick_width(self.slots) + self.slots
            self._rows_host = torch.empty(cap, dtype=torch.long,
                                          pin_memory=True)
            self._rows_dev = torch.empty(cap, dtype=torch.long,
                                         device=self.device)
        if self._rows_in_flight:
            torch.cuda.current_stream(self.device).synchronize()
        self._rows_host.numpy()[:len(ids)] = ids
        index = self._rows_dev[:len(ids)]
        index.copy_(self._rows_host[:len(ids)], non_blocking=True)
        self._rows_in_flight = True
        return index[:n], index[n:]

    def _reset_cold(self, index: torch.Tensor) -> None:
        """Admission's cold resets, in one batch: ``index``'s slots at
        every allocated size, once per entry (their tokens fell due at
        admission)."""
        for size, st in self._slot_states.items():
            self._slot_states[size] = st.reset_rows_at(index)
        self._count(spans.ROWS_RESET, int(index.shape[0]))

    def _scatter(self, size: int, state: DigcState, served: DigcState,
                 bucket_state: DigcState, lanes: torch.Tensor) -> None:
        """Write the served rows of the live ``lanes`` back into ``size``'s
        slot state (rows past them, padding, are dropped). A program that
        passed its state through (``served is bucket_state``, a stateless
        tier) changed no row: writing back the rows the tick gathered
        would change nothing, so nothing is written."""
        if served is bucket_state:
            self._count(spans.SCATTER_SKIPPED)
            return
        self._slot_states[size] = state.put_rows(served, lanes)

    def _lanes(self, size: int, masked: bool, imgs: list, masks: list,
               rows: torch.Tensor) -> tuple:
        """The tick's bucket, cell key, device batch (and mask) and state
        rows for the live lanes' images, padded by replicating lane 0;
        ``rows`` is the padded lane index (``_row_index``)."""
        a = len(imgs)
        bucket = self.bucket_for(a)
        width = self._tick_width(bucket)
        key = self._program_key(bucket, size, masked)
        pad = width - a
        images, mask = self._upload(
            key, imgs + [imgs[0]] * pad,
            masks + [masks[0]] * pad if masked else None)
        return bucket, key, images, mask, self._slot_states[size].take_rows(rows)

    def step(self) -> int:
        """One tick: pick a cell, bind its queued requests to slots,
        screen each lane, serve the healthy ones padded to a bucket.
        Returns the number of requests served (quarantined ones are done,
        with ``fault`` set); 0 when the scheduler defers (no device work,
        ``_tick`` unchanged, no span).

        A tick records an ``engine.step`` span (id: the tick number;
        attributes: the bucket, the live lanes, the served uids and the
        tick's ``engine.syncs``) whose children tile it: ``engine.select``,
        ``engine.stage``, ``engine.screen`` (its event wait in
        ``engine.screen.wait``), ``engine.capture`` on a cell's first tick
        else ``engine.replay``, ``engine.scatter``, ``engine.pull`` and
        ``engine.account``."""
        if not self.queue:
            return 0
        if self.mode != "jit":
            raise RuntimeError(
                "the multi-tenant request path serves through the cell "
                "programs (CUDA graphs on a card); construct with mode='jit'")
        rec = spans.RECORDER
        on = rec.enabled
        t = t_step = spans.now() if on else 0
        cell, eligible = self._select_cell()
        if cell is None:
            self.deferrals += 1
            self._prefetch_parked()
            return 0
        size, masked = cell
        self._tick += 1
        tick = self._tick
        if on:
            sid = rec.open(t_step)
            syncs = rec.counters.get(spans.SYNCS, 0)
        self.last_resets = []
        self.last_restores = []
        self.last_quarantined = []
        used: set[int] = set()
        assigned: dict[int, int] = {}  # id(request) -> slot
        # Pass 1: tenants that own a slot reserve it, so a new tenant can
        # only evict idle slots. One lane per tenant per tick.
        for req in eligible:
            if len(assigned) >= self.slots:
                break
            slot = self._tenant_slot.get(self._tkey(req))
            if slot is not None and slot not in used:
                used.add(slot)
                assigned[id(req)] = slot
        # Pass 2: new tenants, in arrival order.
        for req in eligible:
            if len(assigned) >= self.slots:
                break
            tkey = self._tkey(req)
            if id(req) in assigned or tkey in self._tenant_slot:
                continue
            slot = self._admit(tkey, used)
            if slot is None:
                continue
            used.add(slot)
            assigned[id(req)] = slot
        picked = sorted(((assigned[id(r)], r) for r in eligible
                         if id(r) in assigned), key=lambda sr: sr[0])
        self.queue = [r for r in self.queue if id(r) not in assigned]
        lanes = [slot for slot, _ in picked]
        rows, cold = self._row_index(lanes, self.last_resets)
        if len(cold):
            self._reset_cold(cold)
        if on:
            t = rec.lap("engine.select", t, tick, sid)

        state = self._ensure_slot_state(size)
        # Fault site: an unsanctioned state mutation, adopted without
        # refreshing the integrity tokens (which exist to catch it): the
        # rows the engine wrote since the last tokens are tokened first.
        mutated = self._fire("state.rows", value=state)
        if mutated is not state:
            self._flush_tokens(size)
            self._slot_states[size] = mutated
        n = (size // self.cfg.patch) ** 2
        imgs: list[np.ndarray] = []
        masks: list[np.ndarray] = []
        for slot, req in picked:
            img = np.asarray(req.image, np.float32)
            fired = self._fire("admit.image", value=img, tenant=req.tenant)
            img = img if fired is img else np.asarray(fired, np.float32)
            if masked:
                if img.shape[0] < size:
                    # Zero-pad the ragged image up to its cell: the patch
                    # embedding is node-local, so live patches see their
                    # own pixels and the pad patches are masked downstream.
                    canvas = np.zeros((size, size, img.shape[-1]), np.float32)
                    canvas[:img.shape[0], :img.shape[1]] = img
                    img = canvas
                mask = self._req_mask(req)
                masks.append(np.ones(n, bool) if mask is None
                             else np.asarray(mask, bool))
            imgs.append(img)
        a = len(lanes)
        bucket, key, images, mask, bucket_state = self._lanes(
            size, masked, imgs, masks, rows)
        if on:
            t = rec.lap("engine.stage", t, tick, sid)
        healthy = picked
        if self.guards:
            if on:
                scr = rec.open(t)
            img_ok, finite, sums, ready = self._screen(images[:a], size)
            if ready is not None:
                if on:
                    tw = spans.now()
                ready.synchronize()
                self._rows_in_flight = False  # the event follows the copy
                if on:
                    rec.lap("engine.screen.wait", tw, tick, scr)
                    rec.count(spans.SYNCS)
            keep, reset = self._screened(picked, size, img_ok, finite, sums)
            if on:
                t = rec.lap("engine.screen", t, tick, sid, seq=scr)
            if not keep:
                self.last_lanes = []
                self.last_bucket = None
                self.last_cell = None
                self._prefetch_parked()
                if on:
                    t = rec.lap("engine.account", t, tick, sid)
                    rec.add("engine.step", t_step, t, tick, seq=sid, attrs=(
                        STEP_ATTRS, None, 0,
                        rec.counters.get(spans.SYNCS, 0) - syncs))
                return 0
            if len(keep) < a or reset:
                # Quarantined lanes never reach the program and recovered
                # rows are served cold: the tick goes up again, in the
                # bucket that fits the healthy lanes. Its index reuses the
                # pinned buffer: the screen's event, waited on above, was
                # recorded after the first copy from it.
                healthy = [picked[i] for i in keep]
                lanes = [slot for slot, _ in healthy]
                a = len(lanes)
                rows, _ = self._row_index(lanes)
                bucket, key, images, mask, bucket_state = self._lanes(
                    size, masked, [imgs[i] for i in keep],
                    [masks[i] for i in keep] if masked else [], rows)
                if on:
                    t = rec.lap("engine.stage", t, tick, sid)
        self.last_lanes = list(lanes)
        self.last_bucket = bucket
        self.last_cell = (size, bucket)
        state = self._slot_states[size]
        # The timed serve section, from here to the logits on the host:
        # the program (built and captured on the cell's first tick), the
        # scatter and the host sync that brings the logits back.
        t_serve = t if on else spans.now()
        first_tick = key not in self._program_ticks
        program = self._program_for(bucket, size, masked)
        self._fire("tick.serve", bucket=bucket)
        reads = gate_reads()
        logits, new_bucket_state = self._serve(key, program, images,
                                               bucket_state, mask)
        reads = gate_reads() - reads
        self.gate_reads += reads
        if on:
            if reads and logits.is_cuda:
                rec.count(spans.SYNCS, reads)
            t = rec.lap("engine.capture" if first_tick else "engine.replay",
                        t, tick, sid, keep=first_tick)
        self._scatter(size, state, new_bucket_state, bucket_state, rows[:a])
        # The written rows' new tokens ride the logits' transfer: their
        # copy is queued first, and the logits' host sync closes both. A
        # program that passed the state through (a stateless tier) wrote
        # no row: their tokens stand.
        if self.guards and new_bucket_state is not bucket_state:
            self._tokens_due.update((size, s) for s in lanes)
        due = self._due(size)
        if due:
            sums = _to_host_async(self._slot_states[size].row_checks()[1])
        if on:
            t = rec.lap("engine.scatter", t, tick, sid)
        logits_np = logits[:a].cpu().numpy()  # host sync closes the tick
        self._rows_in_flight = False
        if on and logits.is_cuda:
            rec.count(spans.SYNCS)
        if due:
            self._adopt_tokens(size, due, sums)
        # The graph statistics' reads wait on the device too: in the pull.
        self._graph_stats_update(state, self._slot_states[size], lanes)
        t = rec.lap("engine.pull", t, tick, sid) if on else spans.now()
        elapsed_ms = (t - t_serve) / 1e6
        self._program_ticks[key] = self._program_ticks.get(key, 0) + 1
        if self.deadline_ms is not None and not first_tick:
            # A program's first tick builds and captures it: never a
            # deadline signal.
            if elapsed_ms > self.deadline_ms:
                self.deadline_misses += 1
                self._consecutive_misses += 1
                info = FaultInfo(
                    kind="deadline_miss", site="tick.serve", tick=self._tick,
                    detail=(f"bucket {bucket} tick {elapsed_ms:.2f}ms > "
                            f"budget {self.deadline_ms}ms"))
                self.fault_log.append(info)
                if self._consecutive_misses >= self.deadline_strikes:
                    self._degrade(dataclasses.replace(
                        info, kind="deadline_degrade",
                        detail=(f"{self._consecutive_misses} consecutive "
                                "misses; descending ladder")))
            else:
                self._consecutive_misses = 0
        for i, (slot, req) in enumerate(healthy):
            req.logits = logits_np[i]
            req.done = True
            self._slot_last_tick[slot] = self._tick
            if req.tenant is None:
                self.slot_tenant[slot] = None
                self._tenant_slot.pop(("req", req.uid), None)
        self.requests_served += a
        self.bucket_ticks[bucket] = self.bucket_ticks.get(bucket, 0) + 1
        self.cell_ticks[(size, bucket)] = self.cell_ticks.get((size, bucket), 0) + 1
        # Padding accounting: padded_lanes is the sum over ticks of
        # (width - live), exactly.
        width = self._tick_width(bucket)
        self.live_lanes += a
        self.padded_lanes += width - a
        self.lane_hist[(size, a)] = self.lane_hist.get((size, a), 0) + 1
        self._prefetch_parked()
        if on:
            t = rec.lap("engine.account", t, tick, sid)
            rec.add("engine.step", t_step, t, tick, seq=sid, attrs=(
                STEP_ATTRS, bucket, a, rec.counters.get(spans.SYNCS, 0) - syncs,
                *[req.uid for _, req in healthy]))
        return a

    def run(self) -> list[VigRequest]:
        """Drain the queue; returns the completed requests in submission
        order. Under the scheduler a deferred tick advances time to the
        next deadline (a ``VirtualClock`` jumps, the wall clock sleeps),
        so the drain ends."""
        pending = list(self.queue)
        while self.queue:
            served = self.step()
            if not served and self.queue and self._next_deadline is not None:
                self._advance_to_deadline()
        return [r for r in pending if r.done]

    # -- observability --------------------------------------------------

    def state_steps(self) -> dict:
        """The direct path's state step counters, by batch size."""
        return {b: st.steps() for b, (_, st) in self._direct.items()}

    def slot_row_steps(self, size: Optional[int] = None) -> dict:
        """Per-slot request counters of the canonical state at ``size``
        (default: the first size; empty before its first tick)."""
        st = self._slot_states.get(self.image_sizes[0] if size is None
                                   else size)
        if st is None:
            return {}
        return st.row_steps()

    def stats(self) -> dict:
        out = {
            "requests_served": self.requests_served,
            "mode": self.mode,
            "compile_count": self.compile_count,
            "buckets": self.buckets,
            "image_sizes": self.image_sizes,
            "bucket_ticks": dict(self.bucket_ticks),
            "cell_ticks": {f"{s}x{b}": n
                           for (s, b), n in self.cell_ticks.items()},
            "queue_depth": len(self.queue),
            "live_lanes": self.live_lanes,
            "padded_lanes": self.padded_lanes,
            "util": (self.live_lanes / (self.live_lanes + self.padded_lanes)
                     if self.live_lanes + self.padded_lanes else 1.0),
            "lane_hist": {f"{s}x{live}": n
                          for (s, live), n in sorted(self.lane_hist.items())},
            "deferrals": self.deferrals,
            "slo_ms": (dict(self._slo_ms) if isinstance(self._slo_ms, dict)
                       else self._slo_ms),
            "prefetch_issued": self.prefetch_issued,
            "prefetch_hits": self.prefetch_hits,
            "mesh": (None if self.mesh is None
                     else {k: int(v) for k, v in self.mesh.shape.items()}),
            "slot_tenants": list(self.slot_tenant),
            "digc_state": self.state_steps(),
            "slot_row_steps": self.slot_row_steps(),
            "parked_tenants": list(self._parked),
            "park_hits": self.park_hits,
            "park_evictions": self.park_evictions,
            "graph_reuses": self.graph_reuses,
            "graph_rebuilds": self.graph_rebuilds,
            "gate_reads": self.gate_reads,
            # the row lifecycle: rows_reset, row_index_uploads,
            # scatter_skipped
            **{k.removeprefix("engine."): n
               for k, n in self.row_counts.items()},
            "digc_cache": self.cache.stats(),
            # fault tolerance (DESIGN.md §11)
            "guards": self.guards,
            "quarantines": self.quarantines,
            "state_resets": self.state_resets,
            "deadline_misses": self.deadline_misses,
            "fallback_level": self.fallback_level,
            "park_losses": self.park_losses,
            "retries": self.retries,
            "requests_failed": self.requests_failed,
            "faults": [f.as_dict() for f in self.fault_log[-16:]],
            "drift": {
                "mean": (self._drift_sum / self._drift_n
                         if self._drift_n else 0.0),
                "last": dict(self.last_drift),
            },
        }
        if self.fallback_level > 0:
            chain = fallback_chain(self._ladder_base_impl())
            out["fallback_impl"] = chain[self.fallback_level - 1]
        if self.schedule is not None:
            out["schedule"] = self.schedule.describe()
        if self.tuned is not None:
            out["tuned"] = [r.as_dict() for r in self.tuned]
        if self._bucket_schedules:
            out["bucket_schedules"] = {
                b: s.describe() for b, s in self._bucket_schedules.items()}
        return out


def _check_float(req: VigRequest, img: np.ndarray) -> None:
    if not np.issubdtype(img.dtype, np.floating):
        raise ValueError(
            f"VigRequest.image (uid={req.uid}): dtype {img.dtype} is "
            "not a float dtype; pass float32 pixel features"
        )


def _stage0_impl(choice) -> str:
    """The DIGC impl of a spec, or of a schedule's first stage."""
    return choice.spec_for(0).impl if hasattr(choice, "spec_for") else choice.impl


def _count_sync(t: Optional[torch.Tensor], n: int = 1) -> None:
    """Count ``n`` host waits on the card in ``engine.syncs``: reads of
    ``t`` when it is on a card (None: the caller knows they were)."""
    rec = spans.RECORDER
    if rec.enabled and (t is None or t.is_cuda):
        rec.count(spans.SYNCS, n)


def _to_host_async(t: torch.Tensor) -> torch.Tensor:
    """Queue ``t``'s copy into pinned host memory without waiting (valid
    after the stream's next host sync); on the CPU, ``t``."""
    if not t.is_cuda:
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def _to_device(tree: dict, device: torch.device) -> dict:
    return {k: _to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}
