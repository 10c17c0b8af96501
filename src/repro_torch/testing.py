"""Numpy-only helpers shared by the tests and ``chip_smoke.py``: seeded
inputs and the near-tie-tolerant top-k comparison (which the tuner's
correctness gate uses too)."""

from __future__ import annotations

from typing import Optional

import numpy as np


def topk_mismatch(idx_a, dist_a, idx_b, dist_b, rtol: float = 1e-5,
                  atol: float = 1e-5, exact_rows: bool = False
                  ) -> Optional[str]:
    """Why a top-k result (a) does not match a reference (b), each
    (..., N, k), or None when it matches.

    Distances must be allclose. Indices must be equal, except where the
    two entries are a near-tie: the index a chose sits in b's row at a
    distance within the tolerance of b's distance at that position (or,
    absent from b's row, a's distance there is within the tolerance, as
    checked above). With ``exact_rows`` (both are the exact top-k of
    whole rows, no lane masked), an index absent from b's row must also
    sit where b's distance ties b's last one within twice the tolerance:
    a kept a neighbour that b cut at the end of the row, and each side
    rounded that distance once. No row of a may repeat an index.
    """
    idx_a, idx_b = np.asarray(idx_a), np.asarray(idx_b)
    dist_a = np.asarray(dist_a, np.float64)
    dist_b = np.asarray(dist_b, np.float64)
    if idx_a.shape != idx_b.shape or dist_a.shape != dist_b.shape:
        return (f"shapes differ: idx {idx_a.shape} vs {idx_b.shape}, dist "
                f"{dist_a.shape} vs {dist_b.shape}")
    far = ~np.isclose(dist_a, dist_b, rtol=rtol, atol=atol)
    if far.any():
        at = tuple(int(i) for i in np.argwhere(far)[0])
        return (f"distances differ beyond rtol={rtol}, atol={atol}: "
                f"{int(far.sum())} entries, first at {at}: {dist_a[at]} vs "
                f"{dist_b[at]}")
    rows_a = idx_a.reshape(-1, idx_a.shape[-1])
    srt = np.sort(rows_a, axis=-1)
    if (srt[:, 1:] == srt[:, :-1]).any():
        return "a row of the result repeats an index"
    rows_b = idx_b.reshape(rows_a.shape)
    db = dist_b.reshape(rows_a.shape)
    for r, j in zip(*np.nonzero(rows_a != rows_b)):
        pos = np.nonzero(rows_b[r] == rows_a[r, j])[0]
        if pos.size:
            tie = np.isclose(db[r, pos[0]], db[r, j], rtol=rtol, atol=atol)
        else:
            tie = not exact_rows or np.isclose(db[r, -1], db[r, j],
                                               rtol=2 * rtol, atol=2 * atol)
        if not tie:
            return (f"row {r} position {j}: index {rows_a[r, j]} vs reference "
                    f"{rows_b[r, j]} is no near-tie (reference distances "
                    f"{db[r, pos[0]] if pos.size else 'absent'} and "
                    f"{db[r, j]}, last {db[r, -1]})")
    return None


def assert_topk_match(idx_a, dist_a, idx_b, dist_b, rtol: float = 1e-5,
                      atol: float = 1e-5) -> None:
    """Raise AssertionError where ``topk_mismatch`` finds a reason."""
    why = topk_mismatch(idx_a, dist_a, idx_b, dist_b, rtol=rtol, atol=atol)
    if why is not None:
        raise AssertionError(why)


def features(seed: int, *shape: int) -> np.ndarray:
    """Standard-normal float32 features."""
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def tied_inputs(seed: int, b: int, n: int, m: int, d: int):
    """Nodes (b, n, d) and co-nodes (b, m, d) with exact distance ties:
    small-integer features, so every distance is an exact integer in any
    summation order, and each odd co-node row repeats the row before it.
    The lowest index must win every tie."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-2, 3, (b, n, d)).astype(np.float32)
    y = rng.integers(-2, 3, (b, m, d)).astype(np.float32)
    y[:, 1::2] = y[:, 0:m - 1:2]
    return x, y


def neighbour_ids(seed: int, b: int, n: int, k: int, m: int) -> np.ndarray:
    """Random int32 neighbour lists in [0, m)."""
    return np.random.default_rng(seed).integers(0, m, (b, n, k)).astype(np.int32)


def images(seed: int, b: int, size: int, chans: int = 3) -> np.ndarray:
    """(b, size, size, chans) float32 images."""
    return features(seed, b, size, size, chans)
