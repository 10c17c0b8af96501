"""Functional DIGC state (port of ``repro/core/state.py``).

Construction state that outlives one ``digc()`` call: co-node norms for
a frozen gallery, cluster centroids for warm starts, and the cached,
versioned k-NN graph the stale-graph reuse gate serves. It is a value
threaded through ``digc(..., state=, state_key=) -> (idx, new_state)``,
``vig_forward`` and ``serve.VigServeEngine``: every operation returns a
new state and never mutates its input.

``DigcState.entries`` maps a caller-chosen key (the model stage name) to
a ``DigcStateEntry`` of tensors:

  * ``step``      -- () int32 call counter; 0 means cold.
  * ``centroids`` -- (B, C, D) k-means centroids (the ``cluster`` tier's
    warm start), or None.
  * ``sq_y``      -- (B, M) co-node squared norms (the blocked tier's
    frozen-gallery hook), or None.
  * ``row_step``  -- optional (B,) int32 per-row call counters for
    multi-tenant serving: builders gate warm/cold per batch row, so a
    batch may mix a warm tenant with one just admitted cold.
  * ``graph_idx`` / ``graph_dist`` / ``graph_snap`` / ``graph_age`` --
    the stale-graph buffers: the (B, N, k) graph last built, the (B,)
    feature statistic it was built from and the (B,) age in gated calls.

Invalidation rules:

  * The structure is fixed at init (``DigcState.init`` /
    ``models.vig.init_vig_state``); a builder given no entry for its key
    computes statelessly and the state passes through unchanged.
  * Entry shapes belong to the workload: builders check them and build
    cold on a mismatch rather than read stale-shaped state.
  * ``sq_y`` asserts the gallery named by its key is frozen: re-init the
    state when the gallery changes.
  * Cached graphs invalidate through a shape check, the drift gate
    (``graph_snap`` against the current statistic) and the staleness
    bound (``graph_age`` against ``max_stale``).
  * Rows are per tenant: the serving engine moves them with
    ``take_rows`` / ``put_rows`` / ``reset_rows``; a slot given to a new
    tenant is reset cold, and padding lanes are never scattered back.

Where JAX donates the state into one compiled program, the port's
operations copy: ``take_rows`` gathers new tensors, ``put_rows`` and
``reset_rows`` write into clones.
"""

from __future__ import annotations

import dataclasses
import functools
import zlib
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.device import resolve_device

# Every per-row buffer: the take/put/reset lifecycle, the crc32
# fingerprints and the finiteness screen all iterate this tuple, so the
# cached-graph buffers get the same coverage as the warm-start buffers.
ROW_FIELDS = ("centroids", "sq_y", "row_step",
              "graph_idx", "graph_dist", "graph_snap", "graph_age")
FIELDS = ("step",) + ROW_FIELDS


def _rows_on(rows, device: torch.device) -> torch.Tensor:
    """Row ids as an int64 index tensor on ``device``."""
    if isinstance(rows, torch.Tensor):
        return rows.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(rows, np.int64).reshape(-1),
                           device=device)


@dataclasses.dataclass(frozen=True)
class DigcStateEntry:
    """Per-key functional construction state (see the module docstring)."""

    step: torch.Tensor  # () int32; 0 = cold
    centroids: Optional[torch.Tensor] = None  # (B, C, D)
    sq_y: Optional[torch.Tensor] = None  # (B, M)
    row_step: Optional[torch.Tensor] = None  # (B,) int32; 0 = cold row
    graph_idx: Optional[torch.Tensor] = None  # (B, N, k) int32
    graph_dist: Optional[torch.Tensor] = None  # (B, N, k) f32
    graph_snap: Optional[torch.Tensor] = None  # (B,) f32 drift snapshot
    graph_age: Optional[torch.Tensor] = None  # (B,) int32; 0 = just built

    @property
    def warm(self) -> torch.Tensor:
        """() bool tensor: has this entry been written at least once?"""
        return self.step > 0

    @property
    def row_warm(self) -> Optional[torch.Tensor]:
        """(B,) bool: which rows have been written at least once; None
        when the entry carries no per-row counters."""
        if self.row_step is None:
            return None
        return self.row_step > 0

    def bump(self, **updates) -> "DigcStateEntry":
        """Advance the call counter(s) and replace fields. ``row_step``
        (when present) advances for every row: the serving engine drops
        padding lanes on scatter, so only live rows' counters persist."""
        if self.row_step is not None and "row_step" not in updates:
            updates["row_step"] = self.row_step + 1
        return dataclasses.replace(self, step=self.step + 1, **updates)

    def map(self, fn) -> "DigcStateEntry":
        """Apply ``fn`` to every tensor (None fields stay None)."""
        return DigcStateEntry(**{
            f: None if getattr(self, f) is None else fn(getattr(self, f))
            for f in FIELDS
        })

    # -- per-slot row lifecycle (multi-tenant serving) ------------------

    def take_rows(self, rows) -> "DigcStateEntry":
        """Gather batch rows (repeats allowed: padding lanes replicate a
        live row). Every field is a copy, ``step`` included; nothing
        aliases the source entry."""
        updates = {}
        for f in ROW_FIELDS:
            v = getattr(self, f)
            if v is not None:
                updates[f] = v.index_select(0, _rows_on(rows, v.device))
        updates["step"] = self.step.clone()
        return dataclasses.replace(self, **updates)

    def put_rows(self, src: "DigcStateEntry", rows) -> "DigcStateEntry":
        """Scatter ``src``'s leading rows back: row i of ``src`` lands at
        ``rows[i]``. Rows of ``src`` beyond ``len(rows)`` (padding lanes)
        are dropped. ``step`` is taken from ``src`` (the served entry).
        ``src`` may live on another device (parked host rows)."""
        updates = {"step": src.step.to(self.step.device).clone()}
        for f in ROW_FIELDS:
            dst_v, src_v = getattr(self, f), getattr(src, f)
            if dst_v is None or src_v is None:
                continue
            idx = _rows_on(rows, dst_v.device)
            out = dst_v.clone()
            out[idx] = src_v[:idx.shape[0]].to(dst_v.device, dst_v.dtype)
            updates[f] = out
        return dataclasses.replace(self, **updates)

    def reset_rows(self, rows) -> "DigcStateEntry":
        """Zero the given rows (cold: ``row_step`` 0 routes builders to
        their cold path; the zeros are never read as values)."""
        updates = {}
        for f in ROW_FIELDS:
            v = getattr(self, f)
            if v is None:
                continue
            out = v.clone()
            out[_rows_on(rows, v.device)] = 0
            updates[f] = out
        return dataclasses.replace(self, **updates)


def _row_host(entry: DigcStateEntry, f: str) -> Optional[np.ndarray]:
    v = getattr(entry, f)
    return None if v is None else np.ascontiguousarray(v.detach().cpu().numpy())


@functools.lru_cache(maxsize=8)
def _checksum_weights(n: int, device: torch.device) -> torch.Tensor:
    """(n,) int64 odd weights below 2**15, made once per length."""
    return torch.arange(1, 2 * n, 2, device=device) & 0x7FFF


def entry_row_fingerprint(entry: DigcStateEntry, row: int) -> int:
    """crc32 over one row's bytes across every per-row buffer, in the
    order of ``ROW_FIELDS``: equal to the JAX package's for the same
    values."""
    h = 0
    for f in ROW_FIELDS:
        host = _row_host(entry, f)
        if host is not None:
            h = zlib.crc32(host[row].tobytes(), h)
    return h


def entry_row_finite(entry: DigcStateEntry, row: int) -> bool:
    """True when every float buffer of ``row`` is finite."""
    for f in ROW_FIELDS:
        host = _row_host(entry, f)
        if (host is not None and np.issubdtype(host.dtype, np.floating)
                and not np.isfinite(host[row]).all()):
            return False
    return True


def state_entry(
    *,
    centroids_shape: Optional[tuple[int, ...]] = None,
    sq_y_shape: Optional[tuple[int, ...]] = None,
    graph_shape: Optional[tuple[int, int, int]] = None,
    dtype: torch.dtype = torch.float32,
    rows: Optional[int] = None,
    mesh=None,
    device="cuda",
) -> DigcStateEntry:
    """A cold entry with zero buffers of the given shapes on ``device``.

    The zeros are never read as values: ``step == 0`` (or a zero
    ``row_step``) routes every builder to its cold path. ``rows``
    allocates (rows,) per-row counters for multi-tenant serving;
    ``graph_shape`` (B, N, k) the stale-graph buffers. ``mesh`` placement
    is not ported: any mesh raises.
    """
    if mesh is not None:
        raise NotImplementedError(
            "state_entry(mesh=) places state for sharded construction, "
            "which waits for the mesh slice of the port (ROADMAP queue 1, "
            "items 6 and 8)")
    dev = resolve_device(device)

    def zeros(shape, dt):
        return None if shape is None else torch.zeros(shape, dtype=dt, device=dev)

    graph_b = None if graph_shape is None else (graph_shape[0],)
    return DigcStateEntry(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        centroids=zeros(centroids_shape, dtype),
        sq_y=zeros(sq_y_shape, torch.float32),
        row_step=zeros(None if rows is None else (rows,), torch.int32),
        graph_idx=zeros(graph_shape, torch.int32),
        graph_dist=zeros(graph_shape, torch.float32),
        graph_snap=zeros(graph_b, torch.float32),
        graph_age=zeros(graph_b, torch.int32),
    )


@dataclasses.dataclass(frozen=True)
class DigcState:
    """Keyed collection of ``DigcStateEntry``: the value threaded through
    ``digc()`` / ``vig_forward`` / ``VigServeEngine``."""

    entries: dict[str, DigcStateEntry]

    @classmethod
    def init(cls, entries: Optional[dict[str, DigcStateEntry]] = None):
        return cls(entries=dict(entries or {}))

    def get(self, key: Optional[str]) -> Optional[DigcStateEntry]:
        if key is None:
            return None
        return self.entries.get(key)

    def set(self, key: str, entry: DigcStateEntry) -> "DigcState":
        return DigcState(entries={**self.entries, key: entry})

    def steps(self) -> dict[str, int]:
        """Host-side view of the per-key call counters."""
        return {k: int(e.step) for k, e in self.entries.items()}

    def row_steps(self) -> dict[str, list[int]]:
        """Host-side view of the per-row counters (keys carrying them)."""
        return {k: [int(v) for v in e.row_step.tolist()]
                for k, e in self.entries.items() if e.row_step is not None}

    def to(self, device, *, non_blocking: bool = False,
           pin: bool = False) -> "DigcState":
        """Every tensor copied to ``device``; ``pin`` puts host copies in
        page-locked memory (which a card can read asynchronously)."""
        dev = torch.device(device)

        def move(t):
            out = t.to(dev, non_blocking=non_blocking, copy=True)
            return out.pin_memory() if pin else out

        return DigcState(entries={k: e.map(move)
                                  for k, e in self.entries.items()})

    # -- per-slot row lifecycle (multi-tenant serving) ------------------

    def take_rows(self, rows) -> "DigcState":
        """Gather batch rows from every entry (slot rows -> bucket lanes;
        repeats allowed for padding lanes)."""
        return DigcState(entries={k: e.take_rows(rows)
                                  for k, e in self.entries.items()})

    def put_rows(self, src: "DigcState", rows) -> "DigcState":
        """Scatter ``src``'s leading rows into every entry at ``rows``
        (bucket lanes -> slot rows; padding lanes beyond ``len(rows)``
        are dropped)."""
        return DigcState(entries={k: e.put_rows(src.entries[k], rows)
                                  for k, e in self.entries.items()})

    def reset_rows(self, rows) -> "DigcState":
        """Cold-reset the given rows in every entry."""
        return DigcState(entries={k: e.reset_rows(rows)
                                  for k, e in self.entries.items()})

    # -- integrity guards -----------------------------------------------

    def row_fingerprints(self, rows) -> dict[str, dict[int, int]]:
        """Per-entry crc32 tokens for the given rows; each buffer crosses
        to the host once per call, not once per row."""
        out: dict[str, dict[int, int]] = {}
        for k, e in self.entries.items():
            tokens = {int(r): 0 for r in rows}
            for f in ROW_FIELDS:
                host = _row_host(e, f)
                if host is None:
                    continue
                for r in tokens:
                    tokens[r] = zlib.crc32(host[r].tobytes(), tokens[r])
            out[k] = tokens
        return out

    def rows_finite(self, rows) -> dict[int, bool]:
        """Which of the given rows are finite across every entry."""
        finite = {int(r): True for r in rows}
        for e in self.entries.values():
            for f in ROW_FIELDS:
                host = _row_host(e, f)
                if host is None or not np.issubdtype(host.dtype, np.floating):
                    continue
                for r in finite:
                    if finite[r] and not np.isfinite(host[r]).all():
                        finite[r] = False
        return finite

    def row_checks(self) -> tuple[Optional[torch.Tensor], torch.Tensor]:
        """Every row's screen, on the state's device, in a handful of
        launches and no host read: a (B,) bool, True where every float
        buffer of the row is finite (None when no entry has a float
        buffer), and a (B,) int64 checksum of the row's bits across every
        entry and ``ROW_FIELDS``. The serving engine pulls these, where
        ``rows_finite`` and ``row_fingerprints`` (crc32, equal to JAX's)
        copy every buffer to the host.

        The checksum sums the row's 16-bit halves, read as signed, each
        times an odd weight below 2**15: one flipped bit changes the sum
        by an odd multiple of a power of two below 2**31, and no sum of
        fewer than 2**33 halves overflows, so a single flip always
        shows."""
        bufs = [getattr(e, f) for e in self.entries.values()
                for f in ROW_FIELDS if getattr(e, f) is not None]
        if not bufs:
            raise ValueError("row_checks needs an entry with per-row buffers")
        halves = torch.cat([b.reshape(b.shape[0], -1).view(torch.int16)
                            for b in bufs], dim=1)
        sums = (halves * _checksum_weights(halves.shape[1],
                                           halves.device)).sum(dim=1)
        floats = [b.reshape(b.shape[0], -1) for b in bufs
                  if b.is_floating_point()]
        finite = (torch.isfinite(torch.cat(floats, dim=1)).all(dim=1)
                  if floats else None)
        return finite, sums

    def __len__(self) -> int:
        return len(self.entries)


ParkedRows = Union[DigcState, dict]


def prefetch_park_rows(host_rows: ParkedRows, device="cuda") -> ParkedRows:
    """Start the host -> device copy of parked rows ahead of the tick
    that binds them. ``host_rows`` is a ``DigcState`` of host tensors (or
    a ``{size: DigcState}`` dict); the structure is kept and only the
    tensors move, with ``non_blocking=True``, which is asynchronous from
    pinned host memory on a card. The values are bit-identical to a copy
    made at bind time."""
    dev = resolve_device(device)
    if isinstance(host_rows, dict):
        return {k: prefetch_park_rows(v, dev) for k, v in host_rows.items()}
    return host_rows.to(dev, non_blocking=True)
