"""The traffic generator: one reader for every mix file in ``traffic/``.

A mix is a JSON object whose ``loop`` names its kind:

- ``closed``: ``outstanding`` one-shot requests are kept in flight; a
  new one is sent as each completes.
- ``open``: requests are due on a schedule fixed before the window,
  whatever the system does: ``rate_per_s`` in all, of which
  ``burst_share`` arrive in synchronised bursts of ``burst_size``
  back-to-back requests, evenly spaced over the window, and the rest as
  a Poisson stream (the shape of the port's
  ``serve/sched.py::arrival_trace``, re-parametrised).

Every seed gets the same arrivals: the same number of requests, the
same bursts, and the same Poisson gaps (the exponential distribution's
quantiles, in an order drawn once from the mix's ``arrival_seed``), so
that a run's latency does not depend on how its seed happened to cluster
the arrivals. The run's seed draws each request's input, uniformly from
the cell's pool (and, elsewhere, the weights and the pool).
"""

from __future__ import annotations

import numpy as np

BURST_SPACING_S = 1e-5  # back-to-back arrivals inside a burst


def _quantile_times(n: int, seconds: float, rng: np.random.Generator) -> np.ndarray:
    """``n`` arrival times in [0, seconds): exponential gaps at the
    quantiles (i + 0.5) / n, in a seeded order, scaled to the window."""
    if n <= 0:
        return np.zeros(0)
    q = (np.arange(n) + 0.5) / n
    gaps = rng.permutation(-np.log1p(-q))
    gaps *= seconds / gaps.sum()
    return np.cumsum(gaps) - gaps


def open_schedule(mix: dict, seconds: float, seed: int, pool: int):
    """(due times in seconds from the window's start, sorted; pool index
    of each) for an open-loop mix."""
    rng = np.random.default_rng(int(mix["arrival_seed"]))
    n_total = int(round(float(mix["rate_per_s"]) * seconds))
    size = int(mix["burst_size"])
    n_bursts = int(round(float(mix["burst_share"]) * n_total / size))
    n_single = n_total - n_bursts * size
    singles = _quantile_times(n_single, seconds, rng)
    starts = (np.arange(n_bursts) + 0.5) * (seconds / max(n_bursts, 1))
    bursts = (starts[:, None] + BURST_SPACING_S * np.arange(size)[None, :]).ravel()
    due = np.sort(np.concatenate([singles, bursts]), kind="stable")
    return due, np.random.default_rng(seed).integers(0, pool, size=due.size)


def closed_items(seed: int, pool: int, count: int) -> np.ndarray:
    """The pool index of each of the first ``count`` requests of a
    closed-loop mix, in the order they are sent."""
    return np.random.default_rng(seed).integers(0, pool, size=count)
