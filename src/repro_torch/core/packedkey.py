"""Order-preserving packed (distance, index) keys (port of
``repro/core/packedkey.py``).

One int32 whose integer order is the lexicographic (distance, index)
order:

  * the fp32 distance is made order-monotonic by the IEEE total-order
    flip (non-negative floats keep their bits, negative ones are
    inverted), then its low ``idx_bits`` bits are cleared;
  * the low ``idx_bits = ceil(log2 M)`` bits hold the co-node index.

A truncation tie resolves to the lowest index, the tie rule of
``lax.top_k``. Packed selection is tie-tolerant, not bit-exact: two
distances that agree in their kept high bits order by index.

The JAX package realizes ``topk_keys`` / ``merge_sorted`` as bitonic
networks. Keys of one row are unique (they carry the index), so a sort
of the int32 keys gives the network's result, and that is what this
module computes; the CUDA kernel keeps its own warp network.
"""

from __future__ import annotations

import torch

# Packed-key sentinel: a very large distance with the index bits zeroed.
INT_BIG = 0x7F7F0000

# Beyond 20 index bits fewer than 3 mantissa bits survive.
MAX_IDX_BITS = 20

# Index fill for padded lanes of the exact two-array form: larger than
# any co-node index, so a padding lane loses every distance tie.
IDX_FILL = 0x7FFFFFFF

_INT_MIN = -(2**31)


def idx_bits_for(m: int) -> int:
    """Index bits needed to address co-nodes [0, m); at least 1."""
    if m > (1 << MAX_IDX_BITS):
        raise ValueError(
            f"packed keys support at most {1 << MAX_IDX_BITS} co-nodes "
            f"({MAX_IDX_BITS} index bits); got M={m}. Use an unpacked "
            "merge for larger co-node sets."
        )
    return max(int(m - 1).bit_length(), 1)


def next_pow2(v: int) -> int:
    """Smallest power of two >= v (1 for v <= 1)."""
    return 1 if v <= 1 else 1 << (v - 1).bit_length()


def pack_keys(d: torch.Tensor, idx: torch.Tensor, idx_bits: int) -> torch.Tensor:
    """Order-preserving (distance, index) -> one int32 key.

    Clearing the low bits with a mask equals the reference's arithmetic
    right shift followed by a left shift, without shifting a negative
    value left."""
    bits = d.to(torch.float32).contiguous().view(torch.int32)
    key = torch.where(bits >= 0, bits, torch.bitwise_not(bits) ^ _INT_MIN)
    mask = (1 << idx_bits) - 1
    return (key & ~mask) | (idx.to(torch.int32) & mask)


def unpack_keys(keys: torch.Tensor, idx_bits: int):
    """Inverse of ``pack_keys``: int32 keys -> (fp32 distance, int32 idx).

    The distance keeps the truncation (its low ``idx_bits`` bits cleared),
    as in the reference."""
    mask = (1 << idx_bits) - 1
    idx = keys & mask
    bits = keys & ~mask
    bits = torch.where(bits >= 0, bits, torch.bitwise_not(bits ^ _INT_MIN))
    return bits.contiguous().view(torch.float32), idx


def sort_keys(keys: torch.Tensor) -> torch.Tensor:
    """Ascending sort of packed keys along the last axis."""
    return torch.sort(keys, dim=-1).values


def topk_keys(keys: torch.Tensor, k_pad: int) -> torch.Tensor:
    """Ascending lowest ``k_pad`` keys of the last axis, ``INT_BIG``-padded
    when the axis is shorter."""
    short = k_pad - keys.shape[-1]
    if short > 0:
        fill = keys.new_full(keys.shape[:-1] + (short,), INT_BIG)
        keys = torch.cat([keys, fill], dim=-1)
    return sort_keys(keys)[..., :k_pad]


def merge_sorted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Ascending lowest L of two sorted key lists of equal length L."""
    return sort_keys(torch.cat([a, b], dim=-1))[..., :a.shape[-1]]
