"""Multi-tenant bucketed ViG inference (port of the request path of
``repro/serve/engine.py::VigServeEngine``).

Requests occupy fixed slots (``slots = max(buckets)``). Each tick gathers
the queued requests' slots, one lane per tenant, pads the batch to the
smallest bucket that fits and runs that bucket's program. A tenant keeps
its slot across ticks; a new tenant takes a free slot first, else the
least recently used idle one.

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
state rows pass through unchanged.

Each bucket has one program, the counterpart of the JAX engine's jitted
program per bucket (``mode="jit"``; ``mode="eager"`` makes the request
path raise, as in JAX). On a card the program is captured as one
``torch.cuda.CUDAGraph``: a bucket's first tick is served eagerly on the
capture stream (the capture's warm-up) and then captured from static
buffers (the bucket's device image buffer, filled from a pinned staging
buffer, and the tick's state rows); every later tick copies its rows into
the static inputs, replays, and scatters from the static outputs.
Captured programs are counted in ``compile_count`` (and reported to
``on_compile``); on the CPU there is nothing to capture, the program runs
eagerly and is counted when it is built. A replay launches the kernels
the capture recorded without calling their wrappers, so the engine adds
the capture's launch tally to the counters at each replay.

Fault tolerance (DESIGN.md §11): ``fault_plan`` (``core.faults``) injects
failures at the engine's sites; ``guards=True`` screens each picked lane
before it reaches the program (a non-finite image or non-finite state
rows quarantine the lane; rows whose checksum tokens no longer match are
served cold), while co-batched lanes are served as if the faulty one never
existed. The screen is taken on the device and pulled once a tick
(``DigcState.row_checks``, where JAX fingerprints rows with crc32 on the
host); the new tokens of the rows a tick writes ride its logits' transfer. A failing program build is retried with backoff and then walks
the degradation ladder (``core.builder.fallback_chain``: ``cuda`` ->
``blocked`` -> ``reference``), as do ``deadline_strikes`` consecutive
ticks over ``deadline_ms`` (a program's first tick, which captures, never
counts). A capture or launch error is not a build failure: it raises out
of ``step()``.

With the config's ``blocked`` tier and ``autotune=True`` the DIGC
schedule is tuned (``core.tuner``): ``warmup()`` tunes a per-stage
``VigSchedule`` at ``batch`` for the direct path, and a bucket's first
tick tunes one schedule per configured bucket (before any capture), whose
candidates include the ``cuda`` kernel with both of its merges. The
tuner's host-keyed JSON cache (``tuner_path``) makes a later engine tune
nothing, and also keeps the bucket set that ``retune_buckets()`` derives
from the served trace's live-lane histogram, which ``buckets="auto"``
reads back. The direct path (``infer``) runs eagerly. Not ported yet:
SLO admission and its parking prefetch, the multi-resolution lattice,
the exact-size policy (``buckets=None``) and the mesh.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.builder import degraded_spec, fallback_chain
from repro_torch.core.digc import gate_reads
from repro_torch.core.faults import FaultError, FaultInfo
from repro_torch.core.state import FIELDS, DigcState
from repro_torch.core.tuner import DigcTuner, VigSchedule, optimal_bucket_set
from repro_torch.device import resolve_device
from repro_torch.kernels import add_launch_counts, uncounted_launches
from repro_torch.models.vig import (
    count_digc_work,
    init_vig_state,
    resolve_digc_spec,
    vig_forward,
    vig_stage_plans,
)


@dataclasses.dataclass
class VigRequest:
    """One image inference request. ``tenant`` names the stream it belongs
    to (consecutive requests of a tenant share a slot); ``tenant=None``
    marks a one-shot request whose slot is freed after its tick."""

    uid: int
    image: np.ndarray  # (H, W, C) float
    tenant: Optional[Any] = None
    logits: Optional[np.ndarray] = None
    done: bool = False
    fault: Optional[FaultInfo] = None  # set when the request was quarantined


@dataclasses.dataclass
class _Captured:
    """One bucket's forward captured as a CUDA graph, with its static
    buffers: replaying reads ``images`` and ``state`` and writes
    ``logits`` and ``new_state``; ``tally`` is the kernel launches one
    replay makes."""

    graph: Any  # torch.cuda.CUDAGraph
    images: torch.Tensor
    state: DigcState
    logits: torch.Tensor
    new_state: DigcState
    tally: dict

    def replay(self, state: DigcState):
        """Copy the tick's rows into the static inputs (the images are
        already there), replay, and return the static outputs, valid until
        the next replay."""
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


class VigServeEngine:
    """Bucketed multi-tenant ViG serving on one device.

    ``params`` is the nested parameter dict (``models.convert``); it is
    moved to ``device``. ``device="cuda"`` (the default) raises on a host
    without a card; pass ``device="cpu"`` for the plain PyTorch path.
    ``digc_impl``: a builder name, a DigcSpec, a pre-tuned
    ``VigSchedule`` (applied to every bucket; nothing is tuned), or None
    for ``cfg.digc_impl``. ``buckets``: a tuple, or "auto" for the bucket
    set the tuner cache holds for this serving shape (the default ladder
    capped at ``batch`` when it holds none). ``bucket_cap`` caps the
    programs ``retune_buckets()`` may choose. ``park_capacity`` bounds the
    evicted tenants whose state rows are parked (0: an evicted tenant
    returns cold). ``mode`` is "jit" (bucket programs, captured on a card)
    or "eager" (the request path raises, as in JAX).

    Faults: ``fault_plan`` arms injection sites; ``guards`` arms the
    screens (finiteness, integrity tokens) and the deadline budget
    ``deadline_ms`` (``deadline_strikes`` consecutive misses descend the
    ladder); a failing build or parking restore is retried
    ``retry_attempts`` times, sleeping ``retry_backoff * 2**attempt``
    seconds between tries.
    """

    def __init__(self, cfg, params: dict, *, digc_impl=None, batch: int = 8,
                 autotune: bool = True, tuner_path=None, mode: str = "jit",
                 buckets=DEFAULT_BUCKETS, bucket_cap: int = 4,
                 on_compile: Optional[Callable[[int], None]] = None,
                 park_capacity: int = 8, fault_plan=None, guards: bool = True,
                 deadline_ms: Optional[float] = None,
                 deadline_strikes: int = 2, retry_attempts: int = 3,
                 retry_backoff: float = 0.02, device="cuda"):
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
        if isinstance(buckets, str):
            if buckets != "auto":
                raise ValueError(
                    f"buckets must be a tuple or 'auto': {buckets!r}")
            buckets = self._auto_bucket_set(self.batch, tuner_path)
        buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints: {buckets!r}")
        self.spec = resolve_digc_spec(cfg, digc_impl)
        vig_stage_plans(cfg, digc_impl)  # VigGridError at construction
        # Only a user-provided schedule applies to every bucket: one that
        # warmup() tuned is a measurement at self.batch.
        self._user_schedule = isinstance(digc_impl, VigSchedule)
        self.schedule = digc_impl if self._user_schedule else None
        self.tuned = None  # per-stage TuneResults once warmed up
        # direct path: batch size -> [program, DigcState]
        self._direct: dict[int, list] = {}
        self._bucket_schedules: dict[int, VigSchedule] = {}
        self._bucket_tuned: dict[int, list] = {}
        self.params = _to_device(params, self.device)
        self.buckets = buckets
        self.slots = max(buckets)
        self.on_compile = on_compile
        self.compile_count = 0
        self.requests_served = 0
        self.queue: list[VigRequest] = []
        self.slot_tenant: list[Optional[Any]] = [None] * self.slots
        self._tenant_slot: dict[Any, int] = {}
        self._slot_last_tick = [0] * self.slots
        self._tick = 0
        self._programs: dict[int, Callable] = {}
        self.bucket_ticks: dict[int, int] = {}
        self.live_lanes = 0
        self.padded_lanes = 0
        self.lane_hist: dict[tuple, int] = {}  # (image size, live) -> ticks
        self.last_lanes: list[int] = []
        self.last_resets: list[int] = []
        self.last_restores: list[int] = []
        self.last_bucket: Optional[int] = None
        # The canonical per-slot state, allocated on the first tick.
        self._slot_state: Optional[DigcState] = None
        # LRU parking: tenant -> its rows in host memory, oldest first.
        self.park_capacity = int(park_capacity)
        self._parked: dict[Any, DigcState] = {}
        self.park_hits = 0
        self.park_evictions = 0
        # Stale-graph accounting, per (lane, entry), from graph_age deltas.
        self.graph_reuses = 0
        self.graph_rebuilds = 0
        self._drift_sum = 0.0
        self._drift_n = 0
        self.last_drift: dict[str, float] = {}  # entry key -> mean drift
        self.gate_reads = 0  # the reuse gate's device -> host reads
        # CUDA-graph bucket programs (on a card): bucket -> _Captured, and
        # bucket -> (pinned host, device) image buffers.
        self._captured: dict[int, _Captured] = {}
        self._staging: dict[int, tuple] = {}
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
        self._row_tokens: dict[int, int] = {}  # slot -> checksum token
        self._tokens_due: set[int] = set()  # slots written, not re-taken
        self._consecutive_misses = 0
        self._program_ticks: dict[int, int] = {}  # bucket -> ticks served

    # -- tuning ---------------------------------------------------------

    def _tuner(self) -> DigcTuner:
        tuner = DigcTuner(self.tuner_path, device=self.device)
        tuner.log = self.tune_log
        return tuner

    def _stage_rows(self) -> list[dict]:
        """One workload row per stage at the native size: pooled stages
        tune their real (N, M) pair, later pyramid stages their own."""
        rows: dict[int, dict] = {}
        for row in count_digc_work(self.cfg):
            rows.setdefault(row["stage"], row)
        return [rows[si] for si in sorted(rows)]

    def _tunes(self) -> bool:
        return self.autotune and self.spec.impl == "blocked"

    def warmup(self, rng_seed: int = 0):
        """Tune a per-stage schedule at ``batch`` for the direct path
        (blocked tier only). The request path tunes per bucket, on a
        bucket's first tick. A no-op when a ``VigSchedule`` was given at
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

    def _bucket_choice(self, bucket: int):
        """The DIGC spec or schedule of one bucket's program. The tuner's
        workload key holds the batch size, so each bucket has its own
        schedule (never warmup()'s, measured at ``batch``); a
        user-provided schedule applies everywhere. The first miss tunes
        every configured bucket at once: a serving replica prepares them
        all anyway, and the cache makes later engines free."""
        if self._user_schedule:
            return self.schedule
        if not self._tunes():
            return self.spec
        if bucket not in self._bucket_schedules:
            targets = set(self.buckets) | {bucket}
            schedules, tuned = self._tuner().tune_bucket_schedules(
                self._stage_rows(), spec=self.spec, buckets=sorted(targets))
            self._bucket_schedules.update(schedules)
            self._bucket_tuned.update(tuned)
        return self._bucket_schedules[bucket]

    def retune_buckets(self, max_programs: Optional[int] = None,
                       force: bool = True) -> tuple:
        """Re-derive the bucket set from the live-lane histogram of the
        served trace (``lane_hist``) with ``core.tuner.optimal_bucket_set``,
        persisted per host in the tuner cache, so the next engine built
        with ``buckets="auto"`` and the same cache starts on it. Takes
        effect live: dropped buckets keep their programs but are never
        picked again; new ones are prepared on first use."""
        hist: dict[int, dict[int, int]] = {}
        for (sz, live), ticks in self.lane_hist.items():
            per = hist.setdefault(sz, {})
            per[live] = per.get(live, 0) + ticks
        cap = self.bucket_cap if max_programs is None else int(max_programs)
        size = self.cfg.image_size
        costs = {size: (size // self.cfg.patch) ** 2}
        if self.tuner_path is not None:
            new = self._tuner().tune_bucket_set(
                hist, slots=self.slots, max_programs=cap, costs=costs,
                sizes=(size,), force=force)
        else:
            new = optimal_bucket_set(hist, slots=self.slots,
                                     max_programs=cap, costs=costs)
        self.buckets = new
        return new

    def _auto_bucket_set(self, slots: int, tuner_path) -> tuple:
        """``buckets="auto"``: the persisted bucket set of this (slots,
        size, cap) serving shape when the tuner cache holds one, else
        the default ladder capped at ``slots``."""
        if tuner_path is not None:
            found = self._tuner().lookup_bucket_set(
                slots=slots, sizes=(self.cfg.image_size,),
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
        """Enqueue a request for the next tick. A malformed image fails
        here, at the submitter, with an error naming the field."""
        img = np.asarray(req.image)
        want = (self.cfg.image_size, self.cfg.image_size, self.cfg.in_chans)
        if img.shape != want:
            raise ValueError(
                f"VigRequest.image (uid={req.uid}): shape {img.shape} does "
                f"not match the engine config {want} (image_size, "
                "image_size, in_chans)"
            )
        if not np.issubdtype(img.dtype, np.floating):
            raise ValueError(
                f"VigRequest.image (uid={req.uid}): dtype {img.dtype} is "
                "not a float dtype; pass float32 pixel features"
            )
        self.queue.append(req)

    def bucket_for(self, active: int) -> int:
        """Smallest bucket that fits ``active`` slots."""
        if not 1 <= active <= self.slots:
            raise ValueError(f"active={active} outside 1..{self.slots}")
        return next(b for b in self.buckets if b >= active)

    def _forward(self, choice) -> Callable:
        """A prepared forward: (images (B, H, W, C), state) -> (logits,
        new state) through the DIGC spec or schedule ``choice``."""
        params, cfg = self.params, self.cfg

        def program(images: torch.Tensor, state: DigcState):
            with torch.inference_mode():
                return vig_forward(params, images, cfg, digc_impl=choice,
                                   state=state)

        return program

    def _choice_for(self, bucket: int):
        """The bucket's DIGC spec or schedule through the degradation
        ladder: the tuned per-bucket choice at level 0, else the next tier
        of ``fallback_chain`` with the common spec fields only."""
        if self.fallback_level == 0:
            return self._bucket_choice(bucket)
        chain = fallback_chain(self._ladder_base_impl())
        return degraded_spec(self.spec, chain[self.fallback_level - 1])

    def _ladder_base_impl(self) -> str:
        return _stage0_impl(self._impl_choice())

    def _build_program(self, bucket: int) -> Callable:
        """One bucket's program: (images (bucket, H, W, C), state) ->
        (logits, new state). Passes the ``program.build`` fault site."""
        choice = self._choice_for(bucket)
        self._fire("program.build", bucket=bucket, impl=_stage0_impl(choice))
        return self._forward(choice)

    def _program_for(self, bucket: int) -> Callable:
        """Program lookup with recovery: a failing build is retried, and a
        tier that keeps failing walks the degradation ladder until a rung
        builds; an exhausted ladder re-raises. The tuned choice is
        resolved first, outside the retry and the ladder (where JAX tunes
        inside its build)."""
        while bucket not in self._programs:
            if self.fallback_level == 0:
                # Tuning builds and times the kernels on the card: a
                # kernel that fails there raises out of step(), never
                # into the ladder below (the ladder steps down tiers, it
                # does not stand in for a broken kernel).
                self._bucket_choice(bucket)
            try:
                prog = self._retry(lambda: self._build_program(bucket))
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
            self._programs[bucket] = prog
            if not self._captures():
                self._count_compile(bucket)
        return self._programs[bucket]

    def _count_compile(self, bucket: int) -> None:
        self.compile_count += 1
        if self.on_compile is not None:
            self.on_compile(bucket)

    # -- CUDA-graph bucket programs -------------------------------------

    def _captures(self) -> bool:
        """Bucket programs are captured as CUDA graphs on a card; on the
        CPU there is nothing to capture and they run eagerly."""
        return self.device.type == "cuda"

    def _upload(self, bucket: int, imgs: list) -> torch.Tensor:
        """The tick's bucket batch (bucket, H, W, C) on the device. On a
        card the images are stacked into the bucket's pinned staging
        buffer and copied without blocking into its device image buffer,
        the captured program's static input."""
        if self.device.type != "cuda":
            return torch.from_numpy(np.stack(imgs))
        if bucket not in self._staging:
            shape = (bucket,) + imgs[0].shape
            self._staging[bucket] = (
                torch.empty(shape, dtype=torch.float32, pin_memory=True),
                torch.empty(shape, dtype=torch.float32, device=self.device))
        host, dev = self._staging[bucket]
        np.stack(imgs, out=host.numpy())
        dev.copy_(host, non_blocking=True)
        return dev

    def _serve(self, bucket: int, program: Callable, images: torch.Tensor,
               bucket_state: DigcState):
        """Run the bucket's program: eagerly on the CPU; on a card, replay
        its captured graph, or on its first tick serve it eagerly on the
        capture stream (the capture's warm-up: cuBLAS handles, the kernel
        library, the kernels' shared-memory attributes) and capture it
        there from ``images`` and ``bucket_state`` as static inputs."""
        if not self._captures():
            return program(images, bucket_state)
        cap = self._captured.get(bucket)
        if cap is not None:
            return cap.replay(bucket_state)
        if self._graph_stream is None:
            self._graph_stream = torch.cuda.Stream(self.device)
        side = self._graph_stream
        current = torch.cuda.current_stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = program(images, bucket_state)
        graph = torch.cuda.CUDAGraph()
        with uncounted_launches() as tally:
            with torch.cuda.graph(graph, stream=side):
                logits, new_state = program(images, bucket_state)
        current.wait_stream(side)
        self._captured[bucket] = _Captured(
            graph=graph, images=images, state=bucket_state, logits=logits,
            new_state=new_state, tally=tally)
        self._count_compile(bucket)
        return out

    def _tkey(self, req: VigRequest):
        return req.tenant if req.tenant is not None else ("req", req.uid)

    def _ensure_slot_state(self) -> DigcState:
        """The canonical per-slot state, allocated from the choice the
        programs resolve: a user-provided schedule's per-stage specs, else
        the engine spec (tuned schedules change no entry shape)."""
        if self._slot_state is None:
            choice = self.schedule if self._user_schedule else self.spec
            self._slot_state = init_vig_state(
                self.cfg, self.slots, choice, per_slot=True,
                device=self.device)
        return self._slot_state

    def release(self, tenant: Any) -> None:
        """Tenant disconnect: free its slot and cold-reset the rows, so the
        next occupant cannot warm-start from them. Its parked copy (if
        any) goes too: a disconnect, unlike an eviction, does not park."""
        self._parked.pop(tenant, None)
        slot = self._tenant_slot.pop(tenant, None)
        if slot is None:
            return
        self.slot_tenant[slot] = None
        if self._slot_state is not None:
            self._reset_rows_all([slot])

    def _park(self, tenant: Any, slot: int) -> None:
        """Copy an evicted tenant's rows to host memory (pinned on a card)
        so a later re-admit restores them warm; beyond ``park_capacity``
        the oldest parked copy is dropped."""
        if self.park_capacity <= 0 or self._slot_state is None:
            return
        host = self._slot_state.take_rows([slot]).to(
            "cpu", pin=self.device.type == "cuda")
        self._parked.pop(tenant, None)  # re-insert = most recent
        self._parked[tenant] = host
        while len(self._parked) > self.park_capacity:
            del self._parked[next(iter(self._parked))]
            self.park_evictions += 1

    def _unpark(self, tenant: Any, slot: int) -> bool:
        """Restore a parked tenant's rows into its new slot; False (the
        caller cold-resets) when nothing is parked. Only row fields are
        restored: ``step`` stays the canonical entry's.

        The restore passes the ``park.restore`` fault site: a transient
        error is retried with backoff; ``None`` where a parked copy
        existed is a parking-store loss, counted, and the tenant
        re-admits cold."""
        had_copy = tenant in self._parked
        host = self._parked.pop(tenant, None)
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
        state = self._ensure_slot_state()
        self._slot_state = DigcState(entries={
            k: dataclasses.replace(e.put_rows(host.entries[k], [slot]),
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
        the tenant's parked copy, else cold-reset."""
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
            if self._slot_state is not None:
                self._reset_rows_all([slot])
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

    def _refresh_tokens(self, slots) -> None:
        """Mark ``slots``' rows as written by the engine (admission reset,
        restore, quarantine, corruption recovery): their integrity tokens
        are re-taken at the next flush, which comes before any screen
        reads them, so a later mismatch is an unsanctioned mutation."""
        if self.guards:
            self._tokens_due.update(slots)

    def _flush_tokens(self) -> None:
        """Re-take now the tokens of the rows written since the last
        flush: one device -> host pull."""
        if self._tokens_due and self._slot_state is not None:
            self._adopt_tokens(sorted(self._tokens_due),
                               self._slot_state.row_checks()[1].cpu())

    def _adopt_tokens(self, slots: list, sums: torch.Tensor) -> None:
        """Take ``slots``' checksums from ``sums`` (every row's, on the
        host) as their integrity tokens."""
        for slot in slots:
            self._row_tokens[slot] = int(sums[slot])
        self._tokens_due.difference_update(slots)

    def _screen(self, images: torch.Tensor) -> tuple:
        """Queue the screen of the picked lanes' images (their upload,
        ``images``) and of every slot's rows on the device, and their
        copies to the host; returns the host tensors and an event that
        marks them ready."""
        finite, sums = self._slot_state.row_checks()
        img_ok = torch.isfinite(images.reshape(images.shape[0], -1)).all(dim=1)
        host = [None if t is None else _to_host_async(t)
                for t in (img_ok, finite, sums)]
        ready = None
        if images.is_cuda:
            ready = torch.cuda.Event()
            ready.record()
        return (*host, ready)

    def _screened(self, picked: list, img_ok, finite, sums, ready) -> list:
        """The screen's verdicts, once ``ready``: quarantine a lane whose
        image or state rows are not finite, serve cold (reset) a lane
        whose rows' checksum no longer matches its token (rows never
        tokened are trusted, and rows the engine wrote since, take theirs
        now). Returns the healthy lanes' indices in ``picked`` and whether
        a healthy lane's rows were reset."""
        if ready is not None:
            ready.synchronize()
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
            if slot in self._tokens_due or slot not in self._row_tokens:
                self._adopt_tokens([slot], sums)
            elif self._row_tokens[slot] != token:
                # Finite but token-mismatched rows (silent corruption):
                # serve this request cold.
                self._reset_rows_all([slot])
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

    def _reset_rows_all(self, slots) -> None:
        """Cold-reset ``slots``' rows; their tokens fall due."""
        self._slot_state = self._slot_state.reset_rows(list(slots))
        self._refresh_tokens(slots)

    def _quarantine(self, slot: int, req: VigRequest,
                    info: FaultInfo) -> None:
        """Fail one request with a typed ``FaultInfo`` and cold-reset its
        slot; co-batched tenants are untouched (the lane never reaches the
        program)."""
        req.fault = info
        req.logits = None
        req.done = True
        self.quarantines += 1
        self.requests_failed += 1
        self.fault_log.append(info)
        self.last_quarantined.append(slot)
        if self._slot_state is not None:
            self._reset_rows_all([slot])
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

    def step(self) -> int:
        """One tick: bind queued requests to slots, screen each lane, serve
        the healthy ones padded to a bucket. Returns the number of
        requests served (quarantined ones are done, with ``fault`` set)."""
        if not self.queue:
            return 0
        if self.mode != "jit":
            raise RuntimeError(
                "the multi-tenant request path serves through the bucket "
                "programs (CUDA graphs on a card); construct with mode='jit'")
        self._tick += 1
        self.last_resets = []
        self.last_restores = []
        self.last_quarantined = []
        used: set[int] = set()
        assigned: dict[int, int] = {}  # id(request) -> slot
        # Pass 1: tenants that own a slot reserve it, so a new tenant can
        # only evict idle slots. One lane per tenant per tick.
        for req in self.queue:
            if len(assigned) >= self.slots:
                break
            slot = self._tenant_slot.get(self._tkey(req))
            if slot is not None and slot not in used:
                used.add(slot)
                assigned[id(req)] = slot
        # Pass 2: new tenants, in arrival order.
        for req in self.queue:
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
        picked = sorted(((assigned[id(r)], r) for r in self.queue
                         if id(r) in assigned), key=lambda sr: sr[0])
        self.queue = [r for r in self.queue if id(r) not in assigned]

        state = self._ensure_slot_state()
        # Fault site: an unsanctioned state mutation, adopted without
        # refreshing the integrity tokens (which exist to catch it): the
        # rows the engine wrote since the last tokens are tokened first.
        mutated = self._fire("state.rows", value=state)
        if mutated is not state:
            self._flush_tokens()
            self._slot_state = mutated
        imgs: list[np.ndarray] = []
        for slot, req in picked:
            img = np.asarray(req.image, np.float32)
            fired = self._fire("admit.image", value=img, tenant=req.tenant)
            imgs.append(img if fired is img else np.asarray(fired, np.float32))
        a = len(picked)
        bucket = self.bucket_for(a)
        lanes = [slot for slot, _ in picked]
        images = self._upload(bucket, imgs + [imgs[0]] * (bucket - a))
        screen = self._screen(images[:a]) if self.guards else None
        # Padding lanes replicate lane 0, image and state row: their
        # compute mirrors a live lane (warm whenever lane 0 is) and their
        # outputs and state are dropped. The gather overlaps the screen.
        bucket_state = self._slot_state.take_rows(
            lanes + [lanes[0]] * (bucket - a))
        healthy = picked
        if screen is not None:
            keep, reset = self._screened(picked, *screen)
            if not keep:
                self.last_lanes = []
                self.last_bucket = None
                return 0
            if len(keep) < a or reset:
                # Quarantined lanes never reach the program and recovered
                # rows are served cold: the tick goes up again, in the
                # bucket that fits the healthy lanes.
                healthy = [picked[i] for i in keep]
                kept = [imgs[i] for i in keep]
                lanes = [slot for slot, _ in healthy]
                a = len(lanes)
                bucket = self.bucket_for(a)
                images = self._upload(bucket, kept + [kept[0]] * (bucket - a))
                bucket_state = self._slot_state.take_rows(
                    lanes + [lanes[0]] * (bucket - a))
        self.last_lanes = list(lanes)
        self.last_bucket = bucket
        state = self._slot_state
        program = self._program_for(bucket)
        # The timed serve section: the program, the scatter and the host
        # sync that brings the logits back.
        t0 = time.perf_counter()
        self._fire("tick.serve", bucket=bucket)
        reads = gate_reads()
        logits, new_bucket_state = self._serve(bucket, program, images,
                                               bucket_state)
        self.gate_reads += gate_reads() - reads
        # Scatter the live lanes only: rows >= a (padding) are dropped.
        self._slot_state = state.put_rows(new_bucket_state, lanes)
        # The written rows' new tokens ride the logits' transfer: their
        # copy is queued first, and the logits' host sync closes both. A
        # program that passed the state through (a stateless tier) wrote
        # the lanes' rows back unchanged: their tokens stand.
        if self.guards and new_bucket_state is not bucket_state:
            self._tokens_due.update(lanes)
        due = sorted(self._tokens_due)
        if due:
            sums = _to_host_async(self._slot_state.row_checks()[1])
        logits_np = logits[:a].cpu().numpy()  # host sync closes the tick
        if due:
            self._adopt_tokens(due, sums)
        self._graph_stats_update(state, self._slot_state, lanes)
        elapsed_ms = (time.perf_counter() - t0) * 1e3
        first_tick = bucket not in self._program_ticks
        self._program_ticks[bucket] = self._program_ticks.get(bucket, 0) + 1
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
        self.live_lanes += a
        self.padded_lanes += bucket - a
        hk = (self.cfg.image_size, a)
        self.lane_hist[hk] = self.lane_hist.get(hk, 0) + 1
        return a

    def run(self) -> list[VigRequest]:
        """Drain the queue; returns the completed requests in submission
        order."""
        pending = list(self.queue)
        while self.queue:
            self.step()
        return [r for r in pending if r.done]

    # -- observability --------------------------------------------------

    def state_steps(self) -> dict:
        """The direct path's state step counters, by batch size."""
        return {b: st.steps() for b, (_, st) in self._direct.items()}

    def slot_row_steps(self) -> dict:
        """Per-slot request counters of the canonical state (empty before
        the first tick)."""
        if self._slot_state is None:
            return {}
        return self._slot_state.row_steps()

    def stats(self) -> dict:
        out = {
            "requests_served": self.requests_served,
            "mode": self.mode,
            "compile_count": self.compile_count,
            "buckets": self.buckets,
            "bucket_ticks": dict(self.bucket_ticks),
            "live_lanes": self.live_lanes,
            "padded_lanes": self.padded_lanes,
            "lane_hist": {f"{s}x{live}": n
                          for (s, live), n in sorted(self.lane_hist.items())},
            "slot_tenants": list(self.slot_tenant),
            "digc_state": self.state_steps(),
            "slot_row_steps": self.slot_row_steps(),
            "parked_tenants": list(self._parked),
            "park_hits": self.park_hits,
            "park_evictions": self.park_evictions,
            "graph_reuses": self.graph_reuses,
            "graph_rebuilds": self.graph_rebuilds,
            "gate_reads": self.gate_reads,
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


def _stage0_impl(choice) -> str:
    """The DIGC impl of a spec, or of a schedule's first stage."""
    return choice.spec_for(0).impl if hasattr(choice, "spec_for") else choice.impl


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
