"""Numpy-only helpers shared by the tests and ``chip_smoke.py``: seeded
inputs and the near-tie-tolerant top-k comparison."""

from __future__ import annotations

import numpy as np


def assert_topk_match(idx_a, dist_a, idx_b, dist_b, rtol: float = 1e-5,
                      atol: float = 1e-5) -> None:
    """Hold a top-k result (a) against a reference (b), each (..., N, k).

    Distances must be allclose. Indices must be equal, except where the
    two entries are a near-tie: the index a chose sits in b's row at a
    distance within the tolerance of b's distance at that position (or,
    absent from b's row, a's distance there is within the tolerance, as
    checked above). No row of a may repeat an index.
    """
    idx_a, idx_b = np.asarray(idx_a), np.asarray(idx_b)
    dist_a = np.asarray(dist_a, np.float64)
    dist_b = np.asarray(dist_b, np.float64)
    if idx_a.shape != idx_b.shape or dist_a.shape != dist_b.shape:
        raise AssertionError(f"shapes differ: idx {idx_a.shape} vs "
                             f"{idx_b.shape}, dist {dist_a.shape} vs "
                             f"{dist_b.shape}")
    np.testing.assert_allclose(dist_a, dist_b, rtol=rtol, atol=atol)
    rows_a = idx_a.reshape(-1, idx_a.shape[-1])
    srt = np.sort(rows_a, axis=-1)
    if (srt[:, 1:] == srt[:, :-1]).any():
        raise AssertionError("a row of the result repeats an index")
    rows_b = idx_b.reshape(rows_a.shape)
    db = dist_b.reshape(rows_a.shape)
    for r, j in zip(*np.nonzero(rows_a != rows_b)):
        pos = np.nonzero(rows_b[r] == rows_a[r, j])[0]
        if pos.size and not np.isclose(db[r, pos[0]], db[r, j], rtol=rtol,
                                       atol=atol):
            raise AssertionError(
                f"row {r} position {j}: index {rows_a[r, j]} vs reference "
                f"{rows_b[r, j]} is no near-tie (reference distances "
                f"{db[r, pos[0]]} and {db[r, j]})"
            )


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
