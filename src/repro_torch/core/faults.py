"""Deterministic fault injection for the serving stack (port of
``repro/core/faults.py``; DESIGN.md §11).

``FaultPlan`` is a seedable registry of injectors bound to named
**sites** inside ``digc()`` and ``serve.VigServeEngine``. Production code
carries one ``if fault_plan is None`` branch per site and nothing else:
the fault-free path is unchanged.

Sites (the engine fires these; ``digc()`` fires ``digc.x``):

  * ``admit.image``   -- a request's image at tick admission. Injectors
    plant non-finite values per (tenant, tick); the admission screen must
    catch them before they reach a bucket program.
  * ``state.rows``    -- the canonical per-slot ``DigcState`` at the top of
    a tick. Injectors corrupt one row of one entry buffer without going
    through ``put_rows`` / ``reset_rows``: what the integrity tokens
    (``core/state.py::row_fingerprints``) exist to detect.
  * ``program.build`` -- bucket program construction. Injectors raise; the
    engine retries with backoff and then walks the degradation ladder.
  * ``park.restore``  -- a parked tenant's host rows at re-admission.
    Injectors raise transiently (retried) or return ``None`` (a parking
    store loss: the tenant re-admits cold).
  * ``tick.serve``    -- inside the tick's timed serve section. Injectors
    sleep, forcing a deadline miss.
  * ``digc.x``        -- node features entering an eager ``digc()`` call
    (bypassed while the stream is capturing a CUDA graph).

Every injector is deterministic given the plan's seed and the request
trace: random draws (corruption positions, bit indices) come from one
``numpy`` generator in registration order, so a plan with a given seed
plants the same positions and flips the same bits as the JAX package's
plan on the same inputs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

SITES = (
    "admit.image",
    "state.rows",
    "program.build",
    "park.restore",
    "tick.serve",
    "digc.x",
)

_ANY = object()  # match-anything sentinel (None is a real tenant value)


@dataclasses.dataclass(frozen=True)
class FaultInfo:
    """Typed record of one fault, injected or detected.

    ``kind`` names the taxonomy entry (DESIGN.md §11): e.g.
    ``nonfinite_input``, ``state_corruption``, ``nonfinite_state``,
    ``compile_failure``, ``parking_loss``, ``slow_tick``,
    ``deadline_miss``, ``deadline_degrade``. ``site`` is where it fired
    or was caught; ``tenant`` / ``tick`` locate it in the trace. A
    quarantined request carries its ``FaultInfo`` in ``VigRequest.fault``.
    """

    kind: str
    site: str
    tenant: Any = None
    tick: Optional[int] = None
    detail: str = ""

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["tenant"] = None if self.tenant is None else str(self.tenant)
        return d


class FaultError(RuntimeError):
    """An injected (or detected) fault raised as an exception."""

    def __init__(self, info: FaultInfo):
        super().__init__(
            f"injected fault {info.kind!r} at {info.site}"
            + (f" (tick {info.tick})" if info.tick is not None else "")
            + (f": {info.detail}" if info.detail else "")
        )
        self.info = info


@dataclasses.dataclass
class _Injector:
    site: str
    action: Callable  # (value, ctx) -> value; may raise or sleep
    criteria: dict  # ctx key -> required value (_ANY matches all)
    remaining: float  # inf = unlimited

    def matches(self, ctx: dict) -> bool:
        if self.remaining <= 0:
            return False
        for key, want in self.criteria.items():
            if want is _ANY:
                continue
            if ctx.get(key, _ANY) != want:
                return False
        return True


def _host_copy(value) -> np.ndarray:
    """A writable float32 host copy of an image or feature tensor."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return np.array(value, dtype=np.float32, copy=True)


class FaultPlan:
    """Seedable, deterministic fault-injection plan.

    Register injectors with the ``inject_*`` methods, pass the plan to
    ``VigServeEngine(fault_plan=...)`` (or ``digc(fault_plan=...)``) and
    replay a trace. ``fired`` logs every injection that triggered, in
    order.
    """

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._rng = np.random.default_rng(self.seed)
        self._injectors: list[_Injector] = []
        self.fired: list[FaultInfo] = []

    # -- firing (called from the instrumented sites) --------------------

    def fire(self, site: str, value=None, **ctx):
        """Run every armed injector registered at ``site`` whose criteria
        match ``ctx``; returns the (possibly replaced) value. Injectors may
        raise ``FaultError`` or sleep instead."""
        for inj in self._injectors:
            if inj.site != site or not inj.matches(ctx):
                continue
            inj.remaining -= 1
            value = inj.action(value, ctx)
        return value

    def counts(self) -> dict:
        """Fired-injection counts by kind."""
        out: dict[str, int] = {}
        for f in self.fired:
            out[f.kind] = out.get(f.kind, 0) + 1
        return out

    # -- registration ---------------------------------------------------

    def _add(self, site: str, action, criteria: dict, times) -> "FaultPlan":
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r}; sites: {SITES}")
        self._injectors.append(_Injector(
            site=site, action=action, criteria=criteria,
            remaining=float("inf") if times is None else float(times),
        ))
        return self

    def _log(self, kind: str, site: str, ctx: dict, detail: str = ""):
        info = FaultInfo(
            kind=kind, site=site, tenant=ctx.get("tenant"),
            tick=ctx.get("tick"), detail=detail,
        )
        self.fired.append(info)
        return info

    def inject_nonfinite_input(self, tenant=_ANY, *, tick=None, count=3,
                               mode="nan", times=1,
                               site="admit.image") -> "FaultPlan":
        """Plant ``count`` non-finite values (``mode``: nan | inf | -inf)
        at seeded positions of the matched image or features."""
        fill = {"nan": np.nan, "inf": np.inf, "-inf": -np.inf}[mode]

        def action(value, ctx):
            img = _host_copy(value)
            flat = img.reshape(-1)
            pos = self._rng.integers(0, flat.size, size=min(count, flat.size))
            flat[pos] = fill
            self._log("nonfinite_input", site, ctx,
                      f"{mode} at {len(pos)} seeded positions")
            return img

        crit = {"tenant": tenant}
        if tick is not None:
            crit["tick"] = tick
        return self._add(site, action, crit, times)

    def inject_state_corruption(self, *, key=None, field="centroids",
                                row=0, tick=None, mode="bitflip",
                                times=1) -> "FaultPlan":
        """Corrupt one row of one ``DigcStateEntry`` buffer outside the
        sanctioned row lifecycle. ``mode="bitflip"`` XORs a seeded bit of
        the row's bytes (a finite wrong value: only the integrity
        fingerprint can catch it); ``mode="nan"`` plants a NaN (float
        fields only). The row is corrupted in a host copy and uploaded to
        the entry's device. On the stateless ``cuda`` tier entries carry
        ``row_step`` only: corrupt ``field="row_step", mode="bitflip"``."""
        if mode not in ("bitflip", "nan"):
            raise ValueError(f"mode must be 'bitflip' or 'nan': {mode!r}")

        def action(state, ctx):
            from repro_torch.core.state import DigcState

            keys = [key] if key is not None else [
                k for k, e in state.entries.items()
                if getattr(e, field, None) is not None
            ]
            if (not keys or state.entries.get(keys[0]) is None
                    or getattr(state.entries[keys[0]], field, None) is None):
                raise ValueError(
                    f"no state entry carries field {field!r} to corrupt"
                )
            k = keys[0]
            entry = state.entries[k]
            dev = getattr(entry, field)
            buf = np.array(dev.detach().cpu().numpy(), copy=True)
            rowv = buf.reshape(buf.shape[0], -1)[row]
            if mode == "nan":
                if not np.issubdtype(rowv.dtype, np.floating):
                    raise ValueError(
                        f"mode='nan' needs a float field, {field} is "
                        f"{rowv.dtype}"
                    )
                rowv[int(self._rng.integers(0, rowv.size))] = np.nan
                detail = f"NaN planted in {k}.{field}[{row}]"
            else:
                raw = rowv.view(np.uint8)
                bit = int(self._rng.integers(0, raw.size * 8))
                raw[bit // 8] ^= np.uint8(1 << (bit % 8))
                detail = f"bit {bit} flipped in {k}.{field}[{row}]"
            self._log("state_corruption", "state.rows", ctx, detail)
            new_entry = dataclasses.replace(
                entry, **{field: torch.from_numpy(buf).to(dev.device)})
            return DigcState(entries={**state.entries, k: new_entry})

        crit = {} if tick is None else {"tick": tick}
        return self._add("state.rows", action, crit, times)

    def inject_build_failure(self, *, bucket=_ANY, impl=_ANY,
                             times=1) -> "FaultPlan":
        """Raise from the program-build site. ``times`` bounds how many
        build attempts fail: transient (under the retry budget) or
        persistent (the engine walks the degradation ladder). ``impl``
        scopes the failure to one tier, so the ladder's fallback build
        can succeed."""

        def action(value, ctx):
            info = self._log(
                "compile_failure", "program.build", ctx,
                f"bucket={ctx.get('bucket')} impl={ctx.get('impl')}",
            )
            raise FaultError(info)

        return self._add(
            "program.build", action, {"bucket": bucket, "impl": impl}, times
        )

    def inject_parking_loss(self, tenant=_ANY, *, times=1) -> "FaultPlan":
        """Parking-store loss: the matched tenant's parked rows are gone at
        restore time (``None``); it must re-admit cold."""

        def action(value, ctx):
            self._log("parking_loss", "park.restore", ctx,
                      "parked rows dropped")
            return None

        return self._add("park.restore", action, {"tenant": tenant}, times)

    def inject_park_restore_error(self, tenant=_ANY, *,
                                  times=1) -> "FaultPlan":
        """Transient host-side restore failure: raises ``times`` times,
        then the (unchanged) rows restore."""

        def action(value, ctx):
            info = self._log("parking_transient", "park.restore", ctx,
                             "transient restore failure")
            raise FaultError(info)

        return self._add("park.restore", action, {"tenant": tenant}, times)

    def inject_slow_tick(self, *, tick=None, seconds=0.05,
                         times=1) -> "FaultPlan":
        """Sleep inside the tick's timed serve section: an artificial
        straggler forcing a deadline miss."""

        def action(value, ctx):
            self._log("slow_tick", "tick.serve", ctx, f"slept {seconds}s")
            time.sleep(seconds)
            return value

        crit = {} if tick is None else {"tick": tick}
        return self._add("tick.serve", action, crit, times)
