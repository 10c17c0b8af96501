"""Multi-tenant bucketed ViG inference (port of the request path of
``repro/serve/engine.py::VigServeEngine``).

Requests occupy fixed slots (``slots = max(buckets)``). Each tick gathers
the queued requests' slots, one lane per tenant, pads the batch to the
smallest bucket that fits and runs that bucket's program. A tenant keeps
its slot across ticks; a new tenant takes a free slot first, else the
least recently used idle one. Padding lanes replicate lane 0 and their
outputs are dropped.

Each bucket has one program, built on its first tick and counted in
``compile_count`` (and reported to ``on_compile``). For now a program is
a prepared forward at the bucket's batch size; capturing it as a CUDA
graph is later work.

With the config's ``blocked`` tier and ``autotune=True`` the DIGC
schedule is tuned (``core.tuner``): ``warmup()`` tunes a per-stage
``VigSchedule`` at ``batch`` for the direct path, and a bucket's first
tick tunes one schedule per configured bucket, whose candidates include
the ``cuda`` kernel with both of its merges. The tuner's host-keyed JSON
cache (``tuner_path``) makes a later engine tune nothing, and also keeps
the bucket set that ``retune_buckets()`` derives from the served trace's
live-lane histogram, which ``buckets="auto"`` reads back. Not ported
yet: DIGC state and parking, guards and faults, the degradation ladder,
SLO admission, the multi-resolution lattice, the exact-size policy
(``buckets=None``) and the mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.tuner import DigcTuner, VigSchedule, optimal_bucket_set
from repro_torch.device import resolve_device
from repro_torch.models.vig import (
    count_digc_work,
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
    programs ``retune_buckets()`` may choose.
    """

    def __init__(self, cfg, params: dict, *, digc_impl=None, batch: int = 8,
                 autotune: bool = True, tuner_path=None,
                 buckets=DEFAULT_BUCKETS, bucket_cap: int = 4,
                 on_compile: Optional[Callable[[int], None]] = None,
                 device="cuda"):
        self.device = resolve_device(device)
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
        self._direct: dict[int, Callable] = {}  # direct path, by batch size
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
        self.last_bucket: Optional[int] = None

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
            self._direct[b] = self._forward(self._impl_choice())
        logits = self._direct[b](imgs)
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
        """A prepared forward: images (B, H, W, C) -> logits through the
        DIGC spec or schedule ``choice``."""
        params, cfg = self.params, self.cfg

        def program(images: torch.Tensor) -> torch.Tensor:
            with torch.inference_mode():
                return vig_forward(params, images, cfg, digc_impl=choice)

        return program

    def _build_program(self, bucket: int) -> Callable:
        """One bucket's program: images (bucket, H, W, C) -> logits."""
        return self._forward(self._bucket_choice(bucket))

    def _program_for(self, bucket: int) -> Callable:
        if bucket not in self._programs:
            self._programs[bucket] = self._build_program(bucket)
            self.compile_count += 1
            if self.on_compile is not None:
                self.on_compile(bucket)
        return self._programs[bucket]

    def _tkey(self, req: VigRequest):
        return req.tenant if req.tenant is not None else ("req", req.uid)

    def _admit(self, tenant_key, used: set) -> Optional[int]:
        """Bind a new tenant to a free slot, else the least recently used
        slot not serving this tick; None when every slot is busy."""
        free = [s for s in range(self.slots)
                if self.slot_tenant[s] is None and s not in used]
        if free:
            slot = free[0]
        else:
            idle = [s for s in range(self.slots) if s not in used]
            if not idle:
                return None
            slot = min(idle, key=lambda s: self._slot_last_tick[s])
            del self._tenant_slot[self.slot_tenant[slot]]
        self.slot_tenant[slot] = tenant_key
        self._tenant_slot[tenant_key] = slot
        return slot

    def step(self) -> int:
        """One tick: bind queued requests to slots, serve them padded to
        a bucket. Returns the number of requests served."""
        if not self.queue:
            return 0
        self._tick += 1
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

        lanes = [slot for slot, _ in picked]
        a = len(lanes)
        bucket = self.bucket_for(a)
        self.last_lanes = list(lanes)
        self.last_bucket = bucket
        imgs = [np.asarray(req.image, np.float32) for _, req in picked]
        imgs += [imgs[0]] * (bucket - a)
        batch = torch.from_numpy(np.stack(imgs)).to(self.device)
        logits = self._program_for(bucket)(batch)
        logits_np = logits[:a].cpu().numpy()  # host sync closes the tick
        for i, (slot, req) in enumerate(picked):
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

    def stats(self) -> dict:
        out = {
            "requests_served": self.requests_served,
            "compile_count": self.compile_count,
            "buckets": self.buckets,
            "bucket_ticks": dict(self.bucket_ticks),
            "live_lanes": self.live_lanes,
            "padded_lanes": self.padded_lanes,
            "lane_hist": {f"{s}x{live}": n
                          for (s, live), n in sorted(self.lane_hist.items())},
            "slot_tenants": list(self.slot_tenant),
        }
        if self.schedule is not None:
            out["schedule"] = self.schedule.describe()
        if self.tuned is not None:
            out["tuned"] = [r.as_dict() for r in self.tuned]
        if self._bucket_schedules:
            out["bucket_schedules"] = {
                b: s.describe() for b, s in self._bucket_schedules.items()}
        return out


def _to_device(tree: dict, device: torch.device) -> dict:
    return {k: _to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}
