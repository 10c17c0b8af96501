"""Workload autotuner for DIGC (port of ``repro/core/tuner.py``).

Picks ``(block_n, block_m, merge, fuse_norms)`` for the streaming engine
or a fused-kernel config ``(impl="cuda", block_n, block_m, kernel_merge)``
per ``(backend, B, N, M, D, kd, causal, pos_bias)`` workload, so
kernel-vs-engine is a measured per-workload choice:

  1. rank the candidate grid with the analytical cost models
     (``perfmodel.engine_cost_estimate`` for engine schedules,
     ``perfmodel.kernel_cost_estimate`` for kernel configs: the Hopper
     estimate on a card, a penalty on the CPU, where a ``cuda`` candidate
     runs the kernel's plain version);
  2. measure the top-ranked candidates on the live workload tensors
     (the median host-clock time of a few calls on the CPU; CUDA events
     around loops of back-to-back calls on a card, and there, for the
     candidates within 10% of the fastest, their device time, which
     decides between them: ``pick_best``);
  3. verify each measured candidate's neighbour lists against an exact
     oracle config on the same probe input, so a tie-tolerant variant is
     only chosen when it matched on the workload it will serve. A match
     is distances within fp32 rounding (rtol 1e-5, and 1e-5 of the
     largest squared norms) of the oracle's and equal indices except at
     the oracle's near-ties (``matches_oracle``): on a card the kernel
     and cuBLAS round the same distance apart, and a near-tie may then
     swap;
  4. persist the winner to a JSON cache keyed by the workload, so later
     runs (and serving engines) skip the measurement.

The JSON cache is host-keyed (schema 3): entries nest under
``host_key()`` = backend + platform + torch version + CUDA version +
device name, so a schedule tuned on one machine is never reused on
another. Each host slot holds ``"schedules"`` (keyed by
``workload_key``) and ``"bucket_sets"`` (the serving engine's
arrival-histogram bucket sets, keyed by ``bucket_set_key``). Schema-2
files (hosts mapping straight to schedule entries) migrate on load;
schema-1 files (flat, backend-only keys) are dropped and re-measured.

``VigSchedule`` maps pyramid stages to tuned specs; ``tune_schedule``
tunes each stage's (N, M, D, kd) workload separately, and
``VigSchedule.with_reuse`` overlays a stale-graph reuse policy on the
stages whose tier carries state. ``tune_reuse`` picks that policy's
drift gate by replaying a captured feature trace.

Reuse knobs and the search: as in the JAX package, a ``cuda`` candidate
keeps the spec's reuse knobs (``TileConfig.apply``), and the stateless
``cuda`` builder rejects them, so ``tune`` raises ValueError when it
measures a kernel candidate for a spec that carries them. Tune the
schedule without reuse, then overlay it with ``with_reuse``.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import platform
import time
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.builder import DigcSpec
from repro_torch.core.perfmodel import (
    CUDA_BLOCK_N,
    CUDA_CHUNK_M,
    engine_cost_estimate,
    kernel_cost_estimate,
    kernel_tile_defaults,
)
from repro_torch.device import resolve_device
from repro_torch.testing import topk_mismatch

_BLOCK_N_CANDIDATES = (None, 256, 512, 1024)
_BLOCK_M_CANDIDATES = (256, 512, 1024, 2048, 4096)
_EXACT_MERGES = ("select", "topk")
# Fused-kernel candidates compete as first-class configs, with both
# merges of the kernel: the bitonic merge at the kernel's default tile
# (it merges every staged chunk), the legacy merge every chunk and every
# four.
LEGACY_TILES = ((CUDA_BLOCK_N, CUDA_CHUNK_M), (CUDA_BLOCK_N, 4 * CUDA_CHUNK_M))
# A candidate's neighbour lists may differ from the oracle's only where
# the two round one fp32 distance apart (the kernel's FMA chain against
# cuBLAS) and the oracle's distances tie: distances must agree within
# this relative gap, and within it times the largest |x|^2 + |y|^2 in
# absolute terms, since |x|^2 - 2 x.y + |y|^2 cancels (a self-distance is
# a rounded 0).
_MATCH_RTOL = 1e-5

@dataclasses.dataclass(frozen=True)
class TileConfig:
    """One schedule, engine tiles or a fused-kernel config: the tuner's
    unit of search. ``impl`` picks the tier ("blocked" engine schedules;
    "cuda" configs carry the kernel's tile dims and its ``kernel_merge``
    and use ``merge="kernel"`` as a display placeholder)."""

    block_n: Optional[int]
    block_m: int
    merge: str
    fuse_norms: bool = False
    impl: str = "blocked"
    kernel_merge: Optional[str] = None

    def apply(self, spec: DigcSpec) -> DigcSpec:
        if self.impl == "cuda":
            return spec.replace(
                impl="cuda",
                block_n=self.block_n,
                block_m=self.block_m,
                kernel_merge=self.kernel_merge,
                # engine-only knobs must be unset for the kernel builder
                merge=None,
                fuse_norms=None,
                group_w=None,
            )
        return spec.replace(
            block_n=self.block_n,
            block_m=self.block_m,
            merge=self.merge,
            fuse_norms=self.fuse_norms or None,
        )

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class TuneResult:
    config: TileConfig
    us_per_call: float
    exact_match: bool
    source: str  # "measured" | "cached" | "prior"
    # The card's own time per call, measured only for the candidates
    # within ``_NEAR_SHARE`` of the fastest (``pick_best``).
    device_us: Optional[float] = None

    def as_dict(self) -> dict:
        return {
            **self.config.as_dict(),
            "us_per_call": self.us_per_call,
            "exact_match": self.exact_match,
            "source": self.source,
            "device_us": self.device_us,
        }


def host_key(backend: Optional[str] = None,
             device: Union[str, torch.device, None] = None) -> str:
    """Identity of the measuring host: backend, platform, torch version,
    CUDA version and device name.

    A tuned schedule is a measurement of this machine; entries under
    another host key are never read, and a torch or CUDA upgrade, or
    another card, re-measures.
    """
    dev = torch.device(device if device is not None else
                       (backend if backend is not None else "cuda"))
    backend = backend if backend is not None else dev.type
    if dev.type == "cuda":
        # A host without a card can rank for one but never measures there.
        name = (torch.cuda.get_device_name(dev) if torch.cuda.is_available()
                else "no-card")
    else:
        name = platform.processor() or platform.machine()
    return (
        f"{backend}|{platform.system().lower()}-{platform.machine()}"
        f"|torch-{torch.__version__}|cuda-{torch.version.cuda}|{name}"
    )


def workload_key(
    b: int, n: int, m: int, d: int, kd: int,
    causal: bool = False, has_pos: bool = False,
    mesh_shape: Optional[tuple[int, ...]] = None,
) -> str:
    """Workload identity within one host (see ``host_key``).
    ``mesh_shape`` keys a sharded workload apart from the single-device
    one of the same shape."""
    key = f"b{b}:n{n}:m{m}:d{d}:kd{kd}"
    if causal:
        key += ":causal"
    if has_pos:
        key += ":pos"
    if mesh_shape:
        key += ":mesh" + "x".join(str(s) for s in mesh_shape)
    return key


def bucket_set_key(slots: int, sizes, max_programs: int) -> str:
    """Identity of one serving shape for bucket-set persistence: the slot
    count, the configured image sizes and the program-count cap."""
    return (
        f"slots{int(slots)}:cap{int(max_programs)}:sizes"
        + "-".join(str(int(s)) for s in sorted(sizes))
    )


def optimal_bucket_set(
    hist, *, slots: int, max_programs: int = 4, costs=None,
) -> tuple[int, ...]:
    """The bucket set minimizing expected padded-lane work under a
    program-count cap.

    ``hist`` is a serving engine's live-lane histogram, ``{size: {live:
    ticks}}`` or a flat ``{live: ticks}``. Under bucket set S a tick at
    ``live`` lanes pays ``min(b in S : b >= live)`` lanes, weighted by
    ``costs[size]`` (default 1). The optimizer minimizes

        sum_{size, live} hist[size][live] * bucket_S(live) * cost[size]

    by brute force over subsets of the observed live counts (an optimal
    boundary sits on an observed count) of at most ``max_programs``
    buckets, always including ``slots``. Ties break to least work, then
    fewest buckets, then the lexicographically smallest set. An empty
    histogram returns ``(slots,)``."""
    slots = int(slots)
    if slots < 1:
        raise ValueError(f"slots must be >= 1, got {slots}")
    if int(max_programs) < 1:
        raise ValueError(f"max_programs must be >= 1, got {max_programs}")
    if hist and not isinstance(next(iter(hist.values())), dict):
        hist = {None: hist}
    weights: dict[tuple, float] = {}
    for size, per in (hist or {}).items():
        cost = 1.0 if costs is None else float(costs.get(size, 1.0))
        for live, ticks in per.items():
            live = int(live)
            if not 1 <= live <= slots:
                raise ValueError(
                    f"histogram live-lane count {live} outside "
                    f"1..slots={slots}"
                )
            weights[(size, live)] = (
                weights.get((size, live), 0.0) + float(ticks) * cost
            )
    if not weights:
        return (slots,)
    pool = sorted({live for _, live in weights if live < slots})
    best = None
    for r in range(min(int(max_programs) - 1, len(pool)) + 1):
        for extra in itertools.combinations(pool, r):
            cand = tuple(sorted(set(extra) | {slots}))
            work = sum(
                w * min(b for b in cand if b >= live)
                for (_, live), w in weights.items()
            )
            key = (work, len(cand), cand)
            if best is None or key < best:
                best = key
    return best[2]


def matches_oracle(out, oracle, scale: float) -> bool:
    """Whether a candidate's (idx, dist) equal the oracle's up to fp32
    near-ties (``testing.topk_mismatch``): distances within rtol 1e-5 and
    1e-5 of ``scale`` (the largest |x|^2 + |y|^2, plus the largest |bias|)
    absolute, indices equal except where the oracle's own distances tie
    within that tolerance (a neighbour missing from the oracle's row only
    at the row's end), and no index repeated in a row."""
    (idx, dist), (o_idx, o_dist) = ((t.cpu().numpy() for t in r)
                                    for r in (out, oracle))
    return topk_mismatch(idx, dist, o_idx, o_dist, rtol=_MATCH_RTOL,
                         atol=_MATCH_RTOL * scale, exact_rows=True) is None


# Repetitions of a timed loop on a card; the median's per-call time is
# the candidate's.
_CARD_REPS = 3
# Candidates whose call times lie within this share of the fastest are
# paced alike by the host (the two kernel merges: 40 and 52 us of device
# time under ~60 us of host issue at B = 8); among them the least device
# time wins, so the choice does not follow the host's noise.
_NEAR_SHARE = 0.10
# Cycles per second of ``torch.cuda._sleep``, by card index.
_SLEEP_RATE: dict = {}


def time_calls(fn, device: torch.device, iters: int) -> float:
    """Seconds per call of ``fn`` after a first call has run. On the CPU,
    the median host-clock time of ``iters`` single calls (as the JAX
    tuner times). On a card, CUDA events around ``iters`` calls issued
    back to back, the median of ``_CARD_REPS`` such loops: the steady
    per-call time, the larger of the host's issue time and the device
    time, which the card's queue would otherwise hide."""
    if device.type != "cuda":
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return float(np.median(times))
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        per_call = []
        for _ in range(_CARD_REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            per_call.append(start.elapsed_time(end) * 1e-3 / iters)
    return float(np.median(per_call))


def _sleep_rate(device: torch.device) -> float:
    if device.index not in _SLEEP_RATE:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        _SLEEP_RATE[device.index] = 1e10 / start.elapsed_time(end)
    return _SLEEP_RATE[device.index]


def device_time(fn, device: torch.device, iters: int, wall_s: float) -> float:
    """The card's seconds per call of ``fn``: ``iters`` calls queued
    behind a device sleep that outlasts their issue (twice ``wall_s`` a
    call), so CUDA events around them bracket the card's work alone; the
    median of ``_CARD_REPS`` such loops."""
    with torch.cuda.device(device):
        rate = _sleep_rate(device)
        per_call = []
        for _ in range(_CARD_REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            torch.cuda._sleep(int(rate * (2.0 * wall_s * iters + 1e-3)))
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            per_call.append(start.elapsed_time(end) * 1e-3 / iters)
    return float(np.median(per_call))


def pick_best(results: Sequence["TuneResult"]) -> "TuneResult":
    """The fastest result by call time; where device times were measured
    for those within ``_NEAR_SHARE`` of it, the least device time among
    them."""
    best = min(results, key=lambda r: r.us_per_call)
    near = [r for r in results if r.device_us is not None
            and r.us_per_call <= best.us_per_call * (1 + _NEAR_SHARE)]
    return min(near, key=lambda r: r.device_us) if near else best


class DigcTuner:
    """Prior-ranked, measurement-refined, JSON-persisted tile tuner.

    ``device`` is where ``tune_schedule`` makes its probe tensors and
    whose host key the cache uses (default: the card, or ``backend``'s
    device when only a backend is given)."""

    def __init__(
        self,
        path: Optional[Union[str, Path]] = None,
        *,
        device: Union[str, torch.device, None] = None,
        backend: Optional[str] = None,
        measure_iters: Optional[int] = None,
        max_measure: int = 6,
    ):
        if device is None:
            device = backend if backend is not None else "cuda"
        self.device = (resolve_device(device) if backend is None
                       else torch.device(device))
        self.path = Path(path) if path is not None else None
        self.backend = backend if backend is not None else self.device.type
        self.host = host_key(self.backend, self.device)
        # Calls timed per candidate: the JAX tuner's 2 on the CPU; 20
        # back-to-back calls on a card, where one call is 0.04-1 ms and a
        # 20-call loop resolves the merges' 10 us apart (``time_calls``).
        self.measure_iters = measure_iters or (
            20 if self.device.type == "cuda" else 2)
        self.max_measure = max_measure
        # One entry per measured tune(): the workload key and its
        # (B, N, M, D, kd), the ranked candidates with their priors, every
        # measured result and the chosen one.
        self.log: list[dict] = []
        # Full file contents (all hosts) are kept on save; only this
        # host's entries are read.
        self._hosts: dict[str, dict] = {}
        if self.path is not None and self.path.exists():
            data = json.loads(self.path.read_text())
            if data.get("schema") == 3:
                self._hosts = {
                    h: {"schedules": dict(v.get("schedules", {})),
                        "bucket_sets": dict(v.get("bucket_sets", {}))}
                    for h, v in data.get("hosts", {}).items()
                }
            elif data.get("schema") == 2:
                # Hosts mapped straight to their schedule entries: lift
                # them under "schedules", with an empty bucket-set store.
                self._hosts = {
                    h: {"schedules": dict(e), "bucket_sets": {}}
                    for h, e in data.get("hosts", {}).items()
                }
            # schema 1: no host identity, so its entries are dropped.
        slot = self._hosts.setdefault(
            self.host, {"schedules": {}, "bucket_sets": {}}
        )
        self.entries: dict[str, dict] = slot["schedules"]
        self.bucket_sets: dict[str, dict] = slot["bucket_sets"]

    # -- candidate generation -------------------------------------------

    def candidates(
        self, n: int, m: int, *, d: Optional[int] = None,
        kd: Optional[int] = None, allow_approx: bool = False
    ) -> list[TileConfig]:
        block_ns = {bn if (bn is None or bn < n) else None
                    for bn in _BLOCK_N_CANDIDATES}
        block_ms = {min(bm, m) for bm in _BLOCK_M_CANDIDATES}
        block_ms.add(m)
        merges = list(_EXACT_MERGES) + (["packed"] if allow_approx else [])
        out = []
        for bn in sorted(block_ns, key=lambda v: -1 if v is None else v):
            for bm in sorted(block_ms):
                for merge in merges:
                    for fuse in (False, True):
                        out.append(TileConfig(bn, bm, merge, fuse))
        # Fused-kernel configs, all exact (unpacked), so they verify
        # against the same oracle.
        bn, bm = kernel_tile_defaults(n, m, d or 0, kd or 0)
        out.append(TileConfig(bn, bm, "kernel", False, impl="cuda",
                              kernel_merge="bitonic"))
        for bn, bm in LEGACY_TILES:
            out.append(TileConfig(bn, bm, "kernel", False, impl="cuda",
                                  kernel_merge="legacy"))
        return out

    def prior(self, cfg: TileConfig, *, b, n, m, d, kd,
              mxu_bf16: bool = False) -> float:
        """The cost model's seconds for one call of ``cfg`` (a ``cuda``
        config multiplies bf16 operands under ``mxu_bf16``)."""
        if cfg.impl == "cuda":
            return kernel_cost_estimate(
                n, m, d, kd, b=b, block_n=cfg.block_n or CUDA_BLOCK_N,
                block_m=cfg.block_m,
                kernel_merge=cfg.kernel_merge or "bitonic",
                mxu_bf16=mxu_bf16, backend=self.backend,
            )["total_s"]
        return engine_cost_estimate(
            n, m, d, kd, b=b, block_n=cfg.block_n, block_m=cfg.block_m,
            merge=cfg.merge, fuse_norms=cfg.fuse_norms,
            backend=self.backend,
        )["total_s"]

    def rank(
        self, cands: list[TileConfig], *, b, n, m, d, kd,
        mxu_bf16: bool = False,
    ) -> list[TileConfig]:
        return sorted(cands, key=lambda c: self.prior(
            c, b=b, n=n, m=m, d=d, kd=kd, mxu_bf16=mxu_bf16))

    # -- persistence ----------------------------------------------------

    def lookup(self, key: str) -> Optional[TuneResult]:
        e = self.entries.get(key)
        if e is None:
            return None
        return TuneResult(
            TileConfig(e["block_n"], e["block_m"], e["merge"],
                       e.get("fuse_norms", False),
                       e.get("impl", "blocked"),
                       e.get("kernel_merge")),
            e.get("us_per_call", float("nan")),
            e.get("exact_match", True),
            "cached",
            e.get("device_us"),
        )

    def save(self) -> None:
        if self.path is None:
            return
        self.path.write_text(json.dumps(
            {"schema": 3, "hosts": self._hosts},
            indent=2, sort_keys=True,
        ) + "\n")

    def lookup_bucket_set(
        self, *, slots: int, sizes, max_programs: int = 4,
    ) -> Optional[tuple[int, ...]]:
        """The persisted bucket set for one serving shape, or None."""
        e = self.bucket_sets.get(bucket_set_key(slots, sizes, max_programs))
        if e is None:
            return None
        return tuple(int(b) for b in e["buckets"])

    def tune_bucket_set(
        self, hist, *, slots: int, max_programs: int = 4, costs=None,
        sizes=None, force: bool = False,
    ) -> tuple[int, ...]:
        """Persisted ``optimal_bucket_set``: derive the bucket set from an
        arrival histogram and cache it per host and serving shape, so a
        later engine built with ``buckets="auto"`` and the same cache
        starts on it. ``sizes`` pins the shape key (default: the
        histogram's size keys); the histogram is recorded in the entry."""
        if hist and not isinstance(next(iter(hist.values())), dict):
            hist = {None: hist}
        if sizes is None:
            sizes = sorted(s for s in (hist or {}) if s is not None)
        key = bucket_set_key(slots, sizes, max_programs)
        if not force:
            e = self.bucket_sets.get(key)
            if e is not None:
                return tuple(int(b) for b in e["buckets"])
        buckets = optimal_bucket_set(
            hist, slots=slots, max_programs=max_programs, costs=costs
        )
        self.bucket_sets[key] = {
            "buckets": list(buckets),
            "hist": {
                f"{'any' if s is None else s}:{live}": int(t)
                for s, per in (hist or {}).items()
                for live, t in sorted(per.items())
            },
        }
        self.save()
        return buckets

    # -- tuning ---------------------------------------------------------

    def tune(
        self,
        x: torch.Tensor,
        y: Optional[torch.Tensor] = None,
        *,
        spec: DigcSpec,
        pos_bias: Optional[torch.Tensor] = None,
        force: bool = False,
        allow_approx: bool = False,
    ) -> tuple[DigcSpec, TuneResult]:
        """Fill the schedule knobs of ``spec`` for this workload.

        Measures on the live tensors, verifies candidates against an exact
        oracle config on the same input, persists the winner. Returns
        (tuned spec, result). Only the ``blocked`` tier is tunable; other
        impls pass through unchanged. Each measured tuning appends to
        ``self.log``."""
        from repro_torch.core.digc import digc

        if spec.impl != "blocked":
            return spec, TuneResult(
                TileConfig(spec.block_n, spec.block_m or 0,
                           spec.merge or "n/a"),
                float("nan"), True, "prior",
            )
        x3 = x if x.ndim == 3 else x[None]
        b, n, d = x3.shape
        m = n if y is None else y.shape[-2]
        kd = spec.k * spec.dilation
        key = workload_key(b, n, m, d, kd, spec.causal,
                           pos_bias is not None,
                           mesh_shape=spec.mesh_shape())
        if not force:
            cached = self.lookup(key)
            if cached is not None:
                return cached.config.apply(spec), cached

        bf16 = bool(spec.mxu_bf16)
        ranked = self.rank(
            self.candidates(n, m, d=d, kd=kd, allow_approx=allow_approx),
            b=b, n=n, m=m, d=d, kd=kd, mxu_bf16=bf16,
        )
        cands = ranked[: self.max_measure]

        calls = {}

        def run(cfg: TileConfig):
            # Checked on the full top-kd lists (a dilated list keeps every
            # d-th neighbour, so a near-tie swap would drop one from it),
            # timed as the spec serves.
            s = cfg.apply(spec)
            calls[cfg] = lambda: digc(x, y, spec=s, pos_bias=pos_bias,
                                      return_dists=True)
            with torch.inference_mode():
                out = digc(x, y, spec=s.replace(k=kd, dilation=1),
                           pos_bias=pos_bias, return_dists=True)
                calls[cfg]()
                seconds = time_calls(calls[cfg], x.device,
                                     self.measure_iters)
            return out, seconds

        oracle_cfg = TileConfig(None, m, "select", False)
        oracle_out, oracle_t = run(oracle_cfg)
        scale = float(x.square().sum(-1).max()
                      + (x if y is None else y).square().sum(-1).max())
        if pos_bias is not None:
            scale += float(pos_bias.abs().max())
        results = [TuneResult(oracle_cfg, oracle_t * 1e6, True, "measured")]
        for cfg in cands:
            if cfg == oracle_cfg:
                continue
            out, t = run(cfg)
            match = matches_oracle(out, oracle_out, scale)
            results.append(TuneResult(cfg, t * 1e6, match, "measured"))

        eligible = [
            r for r in results
            if r.exact_match or (allow_approx and r.config.merge == "packed")
        ]
        fastest = min(r.us_per_call for r in eligible)
        near = [r for r in eligible
                if r.us_per_call <= fastest * (1 + _NEAR_SHARE)]
        if x.device.type == "cuda" and len(near) > 1:
            with torch.inference_mode():
                for r in near:
                    r.device_us = 1e6 * device_time(
                        calls[r.config], x.device, self.measure_iters,
                        r.us_per_call * 1e-6)
        best = pick_best(eligible)
        self.log.append({
            "key": key,
            "shape": (b, n, m, d, kd),
            "mxu_bf16": bf16,
            "ranked": [(c, self.prior(c, b=b, n=n, m=m, d=d, kd=kd,
                                      mxu_bf16=bf16))
                       for c in ranked],
            "measured": results,
            "chosen": best,
        })
        self.entries[key] = best.as_dict()
        self.save()
        return best.config.apply(spec), best

    # -- per-stage schedules --------------------------------------------

    def tune_schedule(
        self,
        workloads: Sequence[dict],
        *,
        spec: DigcSpec,
        batch: int = 1,
        rng_seed: int = 0,
        force: bool = False,
    ) -> tuple["VigSchedule", list[TuneResult]]:
        """Tune one schedule per model stage.

        ``workloads`` holds one dict per stage, ``{"N", "M", "D", "k",
        "dilation"}`` (e.g. the first row of each stage from
        ``models.vig.count_digc_work``), measured on probe tensors of the
        stage's true shape drawn from ``numpy.random.default_rng(rng_seed)``
        as the JAX package draws them. Returns the ``VigSchedule`` and the
        per-stage results; cached entries are served without measuring.
        """
        rng = np.random.default_rng(rng_seed)
        stages: list[DigcSpec] = []
        results: list[TuneResult] = []
        for work in workloads:
            probe = torch.from_numpy(
                rng.standard_normal((batch, work["N"], work["D"]))
                .astype(np.float32)).to(self.device)
            y_probe = None
            if work["M"] != work["N"]:
                y_probe = torch.from_numpy(
                    rng.standard_normal((batch, work["M"], work["D"]))
                    .astype(np.float32)).to(self.device)
            stage_spec = spec.replace(
                k=work["k"], dilation=work["dilation"],
                block_n=None, block_m=None, merge=None, fuse_norms=None,
                kernel_merge=None,
            )
            tuned, result = self.tune(probe, y_probe, spec=stage_spec,
                                      force=force)
            stages.append(tuned)
            results.append(result)
        return VigSchedule(stages=tuple(stages)), results

    def tune_bucket_schedules(
        self,
        workloads: Sequence[dict],
        *,
        spec: DigcSpec,
        buckets: Sequence[int],
        rng_seed: int = 0,
        force: bool = False,
    ) -> tuple[dict[int, "VigSchedule"], dict[int, list[TuneResult]]]:
        """One ``VigSchedule`` per serving bucket: the workload key holds
        the batch size, and a bucketed engine serves each tick padded to a
        bucket, so a B=8-tuned tile is not a B=1-tuned tile. Returns
        ``{bucket: schedule}`` and the per-bucket results."""
        schedules: dict[int, VigSchedule] = {}
        results: dict[int, list[TuneResult]] = {}
        for b in sorted(set(int(v) for v in buckets)):
            schedules[b], results[b] = self.tune_schedule(
                workloads, spec=spec, batch=b, rng_seed=rng_seed,
                force=force,
            )
        return schedules, results


def scale_tau(tau: float, n_ref: int, n: int) -> float:
    """Normalize a drift gate across N-buckets: the drift statistic is a
    per-row mean over N nodes, so its tick-to-tick fluctuation shrinks
    ~1/sqrt(N); widening by sqrt(n_ref / n) keeps the false-rebuild rate
    comparable across buckets. tau=0 stays exactly 0."""
    if tau == 0.0:
        return 0.0
    return float(tau) * float(np.sqrt(n_ref / max(n, 1)))


@dataclasses.dataclass
class ReuseTuneResult:
    """One measured point of the reuse-policy search."""

    policy: str
    drift_tau: float
    max_stale: int
    reuse_frac: float  # fraction of calls served from the cached graph
    recall: float      # neighbour recall of served vs per-call exact
    admitted: bool     # recall >= floor
    n: Optional[int] = None  # node count, when the trace is single-N

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _served_recall(served: np.ndarray, exact: np.ndarray) -> float:
    k = exact.shape[-1]
    s = served.reshape(-1, k)
    e = exact.reshape(-1, k)
    hits = 0
    for i in range(e.shape[0]):
        hits += len(set(e[i].tolist()) & set(s[i].tolist()))
    return hits / e.size


def tune_reuse(
    ticks: Sequence[Sequence[tuple]],
    *,
    spec: DigcSpec,
    policy: str = "tick",
    taus: Sequence[float] = (0.02, 0.05, 0.1, 0.2),
    max_stale: int = 4,
    recall_floor: float = 0.95,
) -> tuple[DigcSpec, list[ReuseTuneResult]]:
    """Pick the widest drift gate that keeps served-graph recall above
    ``recall_floor``, by replaying a captured feature trace through the
    stale-graph gate.

    ``ticks`` is a sequence of ``digc_capture`` lists, one per
    consecutive ``models.vig.vig_forward`` call on the live stream, each
    holding ``(layer_key, h, cond)`` per DIGC call. The replay mirrors
    ``core.digc._reuse_build`` (the same statistic, strict ``<`` gate and
    staleness bound) on the host against per-call exact graphs, so each
    tau's served recall is measured. Among the candidates whose mean
    recall clears the floor, the one reusing most wins; if none clears
    it, the spec comes back unchanged. The trace is grouped per
    (layer_key, N), and each group gated at ``scale_tau(tau, n_ref, n)``
    with n_ref the largest N in the trace.
    """
    from repro_torch.core.digc import digc, drift_stat

    if policy not in ("layer", "tick", "overlap"):
        raise ValueError(f"tune_reuse: unknown policy {policy!r}")
    base = spec.replace(reuse=None, drift_tau=None, max_stale=None)

    per_key: dict[tuple, list[list[dict]]] = {}
    with torch.inference_mode():
        for tick in ticks:
            seen_this_tick: set = set()
            for layer_key, h, cond in tick:
                x3 = h if h.ndim == 3 else h[None]
                m = cond.shape[-2] if cond is not None else x3.shape[-2]
                dil = max(base.dilation, 1)
                k_eff = min(base.k, m // dil) or 1
                if k_eff * dil > m:
                    dil = 1
                call_spec = base.replace(k=k_eff, dilation=dil)
                gkey = (layer_key, int(x3.shape[-2]))
                rows = per_key.setdefault(gkey, [])
                if gkey not in seen_this_tick:
                    rows.append([])
                seen_this_tick.add(gkey)
                rows[-1].append({
                    "exact": digc(x3, cond, spec=call_spec).cpu().numpy(),
                    "stat": drift_stat(x3).cpu().numpy(),
                })

    ns = sorted({n for _, n in per_key})
    n_ref = ns[-1] if ns else 1
    single_n = ns[0] if len(ns) == 1 else None
    results: list[ReuseTuneResult] = []
    for tau in sorted(set(float(t) for t in taus)):
        recalls: list[float] = []
        reused = 0
        total = 0
        for (_, n), calls_by_tick in per_key.items():
            tau_n = scale_tau(tau, n_ref, n)
            cached = snap = age = None
            for calls in calls_by_tick:
                for ci, call in enumerate(calls):
                    stat, exact = call["stat"], call["exact"]
                    total += stat.shape[0]
                    if cached is None:
                        reuse_row = np.zeros(stat.shape, bool)
                    elif policy == "overlap" or (policy == "tick" and ci > 0):
                        reuse_row = np.ones(stat.shape, bool)
                    else:
                        drift = (np.abs(stat - snap)
                                 / np.maximum(np.abs(snap), 1e-9))
                        reuse_row = (age < max_stale) & (drift < tau_n)
                    reused += int(reuse_row.sum())
                    if reuse_row.all() and policy != "overlap":
                        served = cached
                        age = age + (0 if policy == "tick" and ci > 0 else 1)
                    else:
                        sel = reuse_row.reshape(
                            reuse_row.shape + (1,) * (exact.ndim - 1))
                        served = (np.where(sel, cached, exact)
                                  if cached is not None else exact)
                        cached, snap = exact, stat
                        age = np.where(reuse_row,
                                       (age if age is not None else 0) + 1, 0)
                    recalls.append(_served_recall(served, exact))
        recall = float(np.mean(recalls)) if recalls else 1.0
        frac = reused / total if total else 0.0
        results.append(ReuseTuneResult(
            policy, tau, max_stale, frac, recall,
            bool(recall >= recall_floor), n=single_n,
        ))
        if policy == "overlap":
            break  # tau does not enter the overlap gate

    admitted = [r for r in results if r.admitted]
    if not admitted:
        return spec, results
    best = max(admitted, key=lambda r: (r.reuse_frac, r.drift_tau))
    return spec.replace(reuse=policy, drift_tau=best.drift_tau,
                        max_stale=max_stale), results


@dataclasses.dataclass(frozen=True)
class VigSchedule:
    """Stage -> tuned ``DigcSpec`` map for a pyramid or isotropic model.
    Stages beyond the tuple reuse the last entry, so an isotropic model's
    schedule is one spec."""

    stages: tuple[DigcSpec, ...]

    def spec_for(self, si: int) -> DigcSpec:
        if not self.stages:
            raise ValueError("empty VigSchedule")
        return self.stages[min(si, len(self.stages) - 1)]

    def with_reuse(
        self,
        policy: Optional[str],
        drift_tau: Optional[float] = None,
        max_stale: Optional[int] = None,
    ) -> "VigSchedule":
        """Overlay a stale-graph reuse policy on every stage whose tier
        carries state (``GraphBuilder.supports_state``). Stateless tiers
        (the ``cuda`` kernel) keep their spec: their builder has no cache
        to serve from, and its ``validate`` rejects the knobs.
        ``policy=None`` strips the reuse knobs from every stage."""
        from repro_torch.core.builder import get_builder

        stages = []
        for s in self.stages:
            if policy is None:
                stages.append(s.replace(reuse=None, drift_tau=None,
                                        max_stale=None))
            elif get_builder(s.impl).supports_state:
                stages.append(s.replace(reuse=policy, drift_tau=drift_tau,
                                        max_stale=max_stale))
            else:
                stages.append(s)
        return VigSchedule(stages=tuple(stages))

    def describe(self) -> list[dict]:
        return [
            {
                "stage": si,
                "impl": s.impl,
                "block_n": s.block_n,
                "block_m": s.block_m,
                "merge": s.merge,
                "fuse_norms": bool(s.fuse_norms),
                "kernel_merge": s.kernel_merge,
                "reuse": s.reuse,
            }
            for si, s in enumerate(self.stages)
        ]


def autotune_spec(
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    *,
    spec: DigcSpec,
    pos_bias: Optional[torch.Tensor] = None,
    path: Optional[Union[str, Path]] = None,
    tuner: Optional[DigcTuner] = None,
    **kw,
) -> tuple[DigcSpec, TuneResult]:
    """One-shot convenience: tune ``spec``'s schedule for x/y."""
    tuner = tuner if tuner is not None else DigcTuner(path, device=x.device)
    return tuner.tune(x, y, spec=spec, pos_bias=pos_bias, **kw)
