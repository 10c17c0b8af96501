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
graph is later work. Also not ported yet: DIGC state and parking,
guards and faults, the degradation ladder, SLO admission, the
multi-resolution lattice, the mesh and the tuner.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.vig import resolve_digc_spec, vig_forward, vig_stage_plans


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
    """

    def __init__(self, cfg, params: dict, *, digc_impl="cuda",
                 buckets: tuple = DEFAULT_BUCKETS,
                 on_compile: Optional[Callable[[int], None]] = None,
                 device="cuda"):
        buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints: {buckets!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.spec = resolve_digc_spec(cfg, digc_impl)
        vig_stage_plans(cfg, self.spec)  # VigGridError at construction
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
        self.last_lanes: list[int] = []
        self.last_bucket: Optional[int] = None

    # -- direct fixed-batch path ----------------------------------------

    def infer(self, images) -> torch.Tensor:
        """images (B, H, W, C) -> logits (B, num_classes) on the device."""
        imgs = torch.as_tensor(images, dtype=torch.float32).to(self.device)
        with torch.inference_mode():
            logits = vig_forward(self.params, imgs, self.cfg,
                                 digc_impl=self.spec)
        self.requests_served += int(imgs.shape[0])
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

    def _build_program(self, bucket: int) -> Callable:
        """One bucket's program: images (bucket, H, W, C) -> logits."""
        params, cfg, spec = self.params, self.cfg, self.spec

        def program(images: torch.Tensor) -> torch.Tensor:
            with torch.inference_mode():
                return vig_forward(params, images, cfg, digc_impl=spec)

        return program

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
        return a

    def run(self) -> list[VigRequest]:
        """Drain the queue; returns the completed requests in submission
        order."""
        pending = list(self.queue)
        while self.queue:
            self.step()
        return [r for r in pending if r.done]

    def stats(self) -> dict:
        return {
            "requests_served": self.requests_served,
            "compile_count": self.compile_count,
            "buckets": self.buckets,
            "bucket_ticks": dict(self.bucket_ticks),
            "live_lanes": self.live_lanes,
            "padded_lanes": self.padded_lanes,
            "slot_tenants": list(self.slot_tenant),
        }


def _to_device(tree: dict, device: torch.device) -> dict:
    return {k: _to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}
