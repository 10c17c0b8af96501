"""The DIGC kernel's tensor-core arithmetic, emulated in plain PyTorch on
the CPU and held against the JAX reference.

``csrc/digc_topk.cu`` multiplies on the tensor cores: the fp32 variants
as split TF32 (each operand a = hi + lo with hi = rna_tf32(a), lo =
rna_tf32(a - hi); x.y = hi.hi + hi.lo + lo.hi in fp32), ``mxu_bf16`` as
one product of bf16-rounded operands in fp32. The emulation below rounds
the same way and sums in fp32; at every main-path shape of ``vig_ti_iso``
and ``vig_ti_pyr`` its distances lie within the tolerance that
``chip_smoke.py`` holds the kernel to (ATOL + RTOL * (max |x|^2 + max
|y|^2), RTOL relative) of ``repro.core.digc.pairwise_sq_dists``, and its
top-kd lists match ``repro.core.digc.digc_reference`` up to near-ties.
One-pass TF32 misses that tolerance, which is why the kernel splits.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.digc import digc_reference, pairwise_sq_dists  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.models import vig  # noqa: E402

RTOL, ATOL = 1e-5, 1e-4  # chip_smoke.py's


def tf32(a: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero (cvt.rna.tf32.f32): add half of the dropped 13 bits to the
    magnitude, then clear them."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(a: torch.Tensor):
    hi = tf32(a)
    return hi, tf32(a - hi)


def dists(x, y, dot):
    """(sq_x - 2 x.y) + sq_y in fp32, the kernel's order."""
    return ((x * x).sum(-1)[..., :, None] - 2.0 * dot) + (y * y).sum(-1)[..., None, :]


def split_tf32_dists(x, y):
    xh, xl = split(x)
    yh, yl = split(y)
    t = lambda a, b: a @ b.transpose(-1, -2)  # noqa: E731
    return dists(x, y, (t(xh, yl) + t(xl, yh)) + t(xh, yh))


def one_pass_tf32_dists(x, y):
    return dists(x, y, tf32(x) @ tf32(y).transpose(-1, -2))


def bf16_dists(x, y):
    xr = x.to(torch.bfloat16).float()
    yr = y.to(torch.bfloat16).float()
    return dists(xr, yr, xr @ yr.transpose(-1, -2))


def tolerance(x, y):
    return ATOL + RTOL * float((x * x).sum(-1).max() + (y * y).sum(-1).max())


def main_path_shapes():
    shapes = set()
    for name in ("vig_ti_iso", "vig_ti_pyr"):
        cfg = vig.VIG_VARIANTS[name]
        for plan in vig.vig_stage_plans(cfg, "cuda"):
            d = cfg.embed_dims[plan.index]
            for dil, k in zip(plan.dilations, plan.k_effs):
                shapes.add((plan.n, plan.m, d, k * dil))
    return sorted(shapes)


SHAPES = main_path_shapes()


def _inputs(n, m, d, kd, b=2):
    x = testing.features(n + kd, b, n, d)
    y = testing.features(m + d, b, m, d)
    return x, y


def _topk(dist: torch.Tensor, kd: int):
    """Ascending (distance, index), the lowest index first on a tie."""
    d, i = torch.sort(dist, dim=-1, stable=True)
    return i[..., :kd].numpy(), d[..., :kd].numpy()


def test_main_path_shapes_cover_both_models():
    assert (196, 196, 192, 18) in SHAPES and (3136, 196, 48, 9) in SHAPES


@pytest.mark.parametrize("n,m,d,kd", SHAPES)
def test_split_tf32_distances_and_topk_match_jax(n, m, d, kd):
    x, y = _inputs(n, m, d, kd)
    ref = np.asarray(pairwise_sq_dists(jnp.asarray(x), jnp.asarray(y)))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    emu = split_tf32_dists(tx, ty)
    tol = tolerance(tx, ty)
    np.testing.assert_allclose(emu.numpy(), ref, rtol=RTOL, atol=tol)
    ref_i, ref_d = digc_reference(jnp.asarray(x), jnp.asarray(y), k=kd,
                                  return_dists=True)
    idx, dist = _topk(emu, kd)
    testing.assert_topk_match(idx, dist, np.asarray(ref_i), np.asarray(ref_d),
                              rtol=RTOL, atol=tol)


@pytest.mark.parametrize("n,m,d,kd", [(196, 196, 192, 18), (784, 196, 96, 9)])
def test_bf16_product_matches_rounded_operands(n, m, d, kd):
    """bf16 x bf16 products are exact in fp32: the emulation equals the
    JAX distances of the rounded operands within the same tolerance."""
    x, y = _inputs(n, m, d, kd)
    xr = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    yr = np.array(jnp.asarray(y).astype(jnp.bfloat16).astype(jnp.float32))
    ref = np.asarray(pairwise_sq_dists(jnp.asarray(xr), jnp.asarray(yr)))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    emu = bf16_dists(tx, ty)
    np.testing.assert_allclose(emu.numpy(), ref, rtol=RTOL,
                               atol=tolerance(torch.from_numpy(xr),
                                              torch.from_numpy(yr)))


def test_one_pass_tf32_misses_the_tolerance():
    """Why the kernel splits: at the iso shape one TF32 product per fp32
    product rounds each operand by 2^-11 and misses the tolerance that
    the split keeps by two orders of magnitude."""
    n, m, d, kd = 196, 196, 192, 18
    x, y = _inputs(n, m, d, kd)
    ref = np.asarray(pairwise_sq_dists(jnp.asarray(x), jnp.asarray(y)))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    tol = tolerance(tx, ty)
    one = np.abs(one_pass_tf32_dists(tx, ty).numpy() - ref).max()
    two = np.abs(split_tf32_dists(tx, ty).numpy() - ref).max()
    assert one > tol
    assert two < tol / 10


@pytest.mark.parametrize("kd", [1, 9, 40])
def test_tied_inputs_stay_exact_under_the_split(kd):
    """Small-integer features have no low part, so the split products
    and their sums are exact and ties stay ties: the lowest index wins,
    as in the JAX reference."""
    x, y = testing.tied_inputs(kd, 2, 70, 230, 12)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    assert torch.equal(split(tx)[1], torch.zeros_like(tx))
    emu = split_tf32_dists(tx, ty)
    ref = np.asarray(pairwise_sq_dists(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_array_equal(emu.numpy(), ref)
    ref_i = np.asarray(digc_reference(jnp.asarray(x), jnp.asarray(y), k=kd))
    idx, _ = _topk(emu, kd)
    np.testing.assert_array_equal(idx, ref_i)
