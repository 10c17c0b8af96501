"""The DIGC kernel's legacy merge and its bucket_rounds pre-reduction, on
the CPU (the ``cuda`` builder's plain versions) against the JAX package's
Pallas kernel in interpret mode, on the same numpy inputs.

Tolerances:
- fp32 distances are sums taken in another order on each side: rtol 1e-5,
  atol 1e-4 (values of order 2*D), indices equal except at near-ties;
- packed keys keep 32 - idx_bits bits of the distance (idx_bits of the
  true M), so values within fp32 rounding can truncate one quantum apart:
  relative 2**(idx_bits - 23) on top of the fp32 tolerance;
- lanes at or above BIG / 2 (the legacy fills, causal and pad columns,
  INT_BIG) are compared bit for bit, indices included;
- small-integer features make every distance exact, so there both sides
  agree bit for bit everywhere, ties included.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import perfmodel as jperf  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import vig as jvig  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.core import DigcSpec, digc  # noqa: E402
from repro_torch.core.digc import BIG  # noqa: E402
from repro_torch.core.packedkey import INT_BIG, idx_bits_for  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

RTOL, ATOL = 1e-5, 1e-4


def _both(x, y, pos=None, **kw):
    """(JAX idx, dist), (port idx, dist) as numpy, for one call."""
    ji, jd = jops.digc_topk(jnp.asarray(x), jnp.asarray(y),
                            pos_bias=None if pos is None else jnp.asarray(pos),
                            interpret=True, return_dists=True, **kw)
    ti, td = ops.digc_topk(torch.from_numpy(x), torch.from_numpy(y),
                           pos_bias=None if pos is None else torch.from_numpy(pos),
                           return_dists=True, **kw)
    return (np.asarray(ji), np.asarray(jd)), (ti.numpy(), td.numpy())


def _assert_match(jax_out, port_out, m, packed, scale):
    (ji, jd), (ti, td) = jax_out, port_out
    hi = jd >= BIG / 2
    np.testing.assert_array_equal(td >= BIG / 2, hi)
    np.testing.assert_array_equal(ti[hi], ji[hi])
    np.testing.assert_array_equal(td[hi], jd[hi])
    rtol = RTOL + (2.0 ** (idx_bits_for(m) - 23) if packed else 0.0)
    fill = -1 - np.arange(ji.shape[-1])  # distinct, so no false repeats
    testing.assert_topk_match(np.where(hi, fill, ti), np.where(hi, 0, td),
                              np.where(hi, fill, ji), np.where(hi, 0, jd),
                              rtol=rtol, atol=ATOL + rtol * scale)


# name -> (digc_topk keywords, (B, N, M, D)); bucket cases give block_m.
CASES = {
    "legacy": (dict(k=6, kernel_merge="legacy"), (2, 37, 53, 8)),
    "legacy_dilated": (dict(k=3, dilation=3, kernel_merge="legacy",
                            block_m=16), (1, 40, 90, 8)),
    "legacy_causal": (dict(k=4, kernel_merge="legacy", causal=True),
                      (2, 40, 40, 8)),
    "legacy_causal_tiles": (dict(k=6, kernel_merge="legacy", causal=True,
                                 block_n=16, block_m=16), (1, 70, 70, 8)),
    "legacy_pos": (dict(k=5, kernel_merge="legacy", pos=True),
                   (2, 30, 45, 8)),
    "legacy_bf16": (dict(k=5, kernel_merge="legacy", mxu_bf16=True),
                    (2, 30, 45, 8)),
    "packed_legacy": (dict(k=6, kernel_merge="legacy", packed=True),
                      (2, 37, 53, 8)),
    "packed_legacy_causal": (dict(k=4, kernel_merge="legacy", packed=True,
                                  causal=True), (2, 40, 40, 8)),
    "packed_legacy_causal_tiles": (dict(k=6, kernel_merge="legacy",
                                        packed=True, causal=True, block_n=16,
                                        block_m=8), (1, 40, 70, 8)),
    "bucket1_pad_alias": (dict(k=16, packed=True, bucket_rounds=1),
                          (2, 40, 40, 8)),
    "bucket1_small_m": (dict(k=4, packed=True, bucket_rounds=1, block_m=16),
                        (2, 20, 30, 8)),
    "bucket2_ragged": (dict(k=4, packed=True, bucket_rounds=2, block_m=32),
                       (2, 25, 70, 8)),
    "bucket3_wide": (dict(k=3, packed=True, bucket_rounds=3, block_m=12),
                     (1, 30, 100, 8)),
    "bucket2_kd18_bm252": (dict(k=9, dilation=2, packed=True,
                                bucket_rounds=2, block_m=252),
                           (1, 49, 196, 16)),
    "bucket1_causal_bf16": (dict(k=4, packed=True, bucket_rounds=1,
                                 causal=True, mxu_bf16=True, block_m=16),
                            (1, 40, 40, 8)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_legacy_matches_jax_interpret(name):
    kw, (b, n, m, d) = CASES[name]
    kw = dict(kw)
    x = testing.features(n + m, b, n, d)
    y = testing.features(m + d, b, m, d)
    pos = testing.features(7, b, n, m) if kw.pop("pos", False) else None
    scale = float((x * x).sum(-1).max() + (y * y).sum(-1).max())
    if pos is not None:
        scale += float(np.abs(pos).max())
    _assert_match(*_both(x, y, pos, **kw), m, kw.get("packed", False), scale)


@pytest.mark.parametrize("name", sorted(CASES))
def test_legacy_bitwise_on_exact_distances(name):
    kw, (b, n, m, d) = CASES[name]
    kw = dict(kw)
    x, y = testing.tied_inputs(n, b, n, m, d)
    pos = None
    if kw.pop("pos", False):
        pos = np.random.default_rng(2).integers(-3, 4, (b, n, m))
        pos = pos.astype(np.float32)
    (ji, jd), (ti, td) = _both(x, y, pos, **kw)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)


def test_unpacked_legacy_big_lanes_carry_index_zero():
    """Causal rows with fewer than kd visible columns: the legacy list
    starts as (BIG, 0), so row 0 returns [0, 0, 0, 0] where the bitonic
    merge returns the masked columns [0, 1, 2, 3]."""
    x = testing.features(1, 1, 40, 8)
    (ji, jd), (ti, td) = _both(x, x, k=4, kernel_merge="legacy", causal=True)
    np.testing.assert_array_equal(ti[0, :3], ji[0, :3])
    assert ti[0, 0].tolist() == [0, 0, 0, 0]
    assert td[0, 0, 1:].tolist() == [float(np.float32(BIG))] * 3
    bi = ops.digc_topk(torch.from_numpy(x), torch.from_numpy(x), k=4,
                       causal=True)
    assert bi[0, 0].tolist() == [0, 1, 2, 3]


def test_bucket_rounds_pad_columns_alias_and_int_big_lanes():
    """M = 40, kd = 16, r = 1 (block_m clamps to 128, w = 8): five real
    neighbours; BIG keys of pad columns 40, 48, 56 and of pad columns
    64..120, whose index cut to 6 bits aliases 0, 8, ..., 56 (repeats
    merge once); three INT_BIG lanes at index 0."""
    x = testing.features(5, 1, 40, 8)
    (ji, jd), (ti, td) = _both(x, x, k=16, packed=True, bucket_rounds=1)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)
    big = np.float32(BIG).view(np.int32) & ~np.int32(63)
    assert td[0, 0, 5:13].tolist() == [float(big.view(np.float32))] * 8
    assert ti[0, 0, 5:13].tolist() == [0, 8, 16, 24, 32, 40, 48, 56]
    int_big = float(np.int32(INT_BIG).view(np.float32))
    assert td[0, 0, 13:].tolist() == [int_big] * 3 == [3.3895313892515355e38] * 3
    assert ti[0, 0, 13:].tolist() == [0, 0, 0]


def _main_path_shapes():
    out = set()
    for name in ("vig_ti_iso", "vig_ti_pyr"):
        cfg = jvig.VIG_VARIANTS[name]
        for plan in jvig.vig_stage_plans(cfg):
            d = cfg.embed_dims[plan.index]
            for dil, k in zip(plan.dilations, plan.k_effs):
                out.add((plan.n, plan.m, d, k * dil))
    return sorted(out)


@pytest.mark.parametrize("n,m,d,kd", _main_path_shapes())
def test_default_block_m_resolves_as_in_jax(n, m, d, kd):
    """With block_m unset, a legacy (and so a bucket_rounds) spec takes the
    block_m the JAX wrapper picks; a bitonic one the Hopper default."""
    want = min(jperf.kernel_tile_defaults(n, m, d, kd)[1], -(-m // 128) * 128)
    for kw in (dict(kernel_merge="legacy"), dict(kernel_merge="legacy",
                                                 packed=True)):
        assert ops.resolve_kernel_args(n, m, d, kd, **kw)[1] == want
    if want % kd == 0 and want // kd >= 2:
        merge, bm, _ = ops.resolve_kernel_args(n, m, d, kd, packed=True,
                                               bucket_rounds=2)
        assert (merge, bm) == ("legacy", want)
    merge, bm, rows = ops.resolve_kernel_args(n, m, d, kd)
    assert merge == "bitonic" and rows == min(16, -(-n // 8) * 8)
    assert bm == 64  # the bitonic merge runs on every staged chunk


@pytest.mark.parametrize("kw,match", [
    (dict(kernel_merge="heap"), "unknown kernel_merge"),
    (dict(packed=True, bucket_rounds=2, kernel_merge="bitonic"), "legacy"),
    (dict(bucket_rounds=2), "packed"),
    (dict(packed=True, bucket_rounds=1, block_m=128, k=5), "block_m"),
    (dict(packed=True, bucket_rounds=1, block_m=64, k=64), "block_m"),
    (dict(block_n=128), "row tile"),
    (dict(block_m=0, kernel_merge="legacy"), "block_m"),
    (dict(block_m=128), "every staged chunk"),
    (dict(packed=True, bucket_rounds=12, block_m=512, k=256),
     "shared memory"),
])
def test_argument_errors(kw, match):
    """The JAX wrapper's ValueErrors (tests/test_kernel_merge.py), and a
    tile the kernel cannot take."""
    kw = dict(kw)
    k = kw.pop("k", 4)
    x = torch.zeros(16, 8)
    y = torch.zeros(2048 if k == 256 else 128, 8)
    with pytest.raises(ValueError, match=match):
        ops.digc_topk(x, y, k=k, **kw)
    with pytest.raises(ValueError, match=match):
        digc(x, y, spec=DigcSpec(impl="cuda", k=k, **kw))


def test_packed_m_limit():
    x = torch.zeros(1, 4, 2)
    y = torch.zeros(1, 65537, 2)
    with pytest.raises(ValueError, match="65536"):
        ops.digc_topk(x, y, k=2, packed=True, kernel_merge="legacy")
