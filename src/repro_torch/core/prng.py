"""The port's copy of ``jax.random.permutation(jax.random.PRNGKey(seed), m)``.

The cluster tier's cold start takes the first C entries of that
permutation as its initial centroids; the port reproduces it bit for bit
without JAX. The recipe is JAX's default threefry PRNG with
``jax_threefry_partitionable`` on:

* ``PRNGKey(seed)`` is the key (0, seed);
* ``threefry2x32`` is the 20-round Threefry-2x32 hash with rotations
  13/15/26/6 and 17/29/16/24 and a key injection every four rounds;
* ``split(key)`` hashes the counters (0, 0) and (0, 1) into two new keys;
  ``bits(key, m)`` hashes the counters (0, i) and xors the two words;
* ``permutation`` runs ceil(3 ln m / ln(2^32 - 1)) rounds of
  ``key, sub = split(key)`` each followed by a stable sort of the current
  order by ``bits(sub, m)``.

Keys are Python ints (a handful of scalar hashes on the host); the m-wide
bits and sorts are torch integer ops on the target device (uint32 values
held in int64 under a mask), so nothing is uploaded. A permutation is
cached per (seed, m, device) outside CUDA-graph capture; during a capture
a miss is computed inside the graph and not cached (its memory belongs
to the graph's pool).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry2x32(k1: int, k2: int, x1, x2):
    """The Threefry-2x32 hash of the counters (x1, x2) under the key
    (k1, k2). Counters are Python ints or int64 tensors of uint32 values;
    the result has their type."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x1, x2


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for an int seed in [0, 2^31)."""
    seed = int(seed)
    if not 0 <= seed < 2**31:
        raise ValueError(f"seed must be in [0, 2**31), got {seed}")
    return (0, seed)


def split(key: tuple[int, int]) -> tuple[tuple[int, int], tuple[int, int]]:
    """``jax.random.split(key)``: the keys hashed from counters (0, 0) and
    (0, 1)."""
    return (threefry2x32(*key, 0, 0), threefry2x32(*key, 0, 1))


def bits(key: tuple[int, int], m: int, device) -> torch.Tensor:
    """``jax.random.bits(key, (m,))`` as an (m,) int64 tensor of uint32
    values on ``device``."""
    counters = torch.arange(m, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(*key, torch.zeros_like(counters), counters)
    return b1 ^ b2


def _rounds(m: int) -> int:
    return int(np.ceil(3 * np.log(max(1, m)) / np.log(np.iinfo(np.uint32).max)))


def _permutation(seed: int, m: int, device: torch.device) -> torch.Tensor:
    key = prng_key(seed)
    perm = torch.arange(m, dtype=torch.int64, device=device)
    for _ in range(_rounds(m)):
        key, sub = split(key)
        perm = perm[torch.argsort(bits(sub, m, device), stable=True)]
    return perm


@functools.lru_cache(maxsize=64)
def _cached(seed: int, m: int, device: torch.device) -> torch.Tensor:
    return _permutation(seed, m, device)


def permutation(seed: int, m: int, device) -> torch.Tensor:
    """``jax.random.permutation(jax.random.PRNGKey(seed), m)`` as an (m,)
    int64 tensor on ``device``. The cached tensor is shared by every
    caller: read it, never write it."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        return _permutation(int(seed), int(m), device)
    return _cached(int(seed), int(m), device)
