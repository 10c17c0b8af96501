"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test takes the ``cuda`` fixture, which skips where there is
no card; run them on a GPU host with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances: the kernel sums the distance product in its own order (one
fp32 FMA chain per entry), the plain version in cuBLAS's, so distances
agree to fp32 rounding (rtol 1e-5, atol 1e-4 on distances of order
2*D) and indices agree except at near-ties; packed keys keep
32 - idx_bits bits of the distance, so they add a relative
2**(idx_bits - 23). BIG lanes (causal) must match exactly, indices
included. MRConv does no arithmetic beyond one subtraction and a max, so
it must agree bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import testing  # noqa: E402
from repro_torch.core.digc import BIG  # noqa: E402
from repro_torch.core.graph import grid_pos_bias  # noqa: E402
from repro_torch.core.packedkey import idx_bits_for  # noqa: E402
from repro_torch.core.tuner import LEGACY_TILES  # noqa: E402
from repro_torch.kernels import launch_counts, ops, reset_launch_counts  # noqa: E402
from repro_torch.kernels.digc_topk import digc_topk_cuda, digc_topk_plain  # noqa: E402
from repro_torch.kernels.mrconv import mrconv_cuda, mrconv_plain  # noqa: E402

pytestmark = pytest.mark.gpu

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


# The tensor-core tile's edges (B, N, M, D, kd): D off the MMA depth
# (50), D past one staged x slab of 256 features (300), N and M one past
# a row block and a column chunk (17, 65); the last grid is wider than
# the card's SMs, so it runs the 8-warp blocks, the others the 16-warp
# ones.
TILE_SHAPES = [(2, 17, 65, 50, 9), (1, 17, 65, 300, 5), (3, 65, 130, 50, 16),
               (12, 200, 65, 300, 9)]

# (B, N, M, D, kd): main-path shapes, ragged edges, D off the chunk
# multiple, the longest lists the kernel keeps, and the tile's edges.
DIGC_CASES = [
    (1, 196, 196, 192, 9), (8, 196, 196, 192, 27), (2, 3136, 196, 48, 9),
    (2, 784, 196, 96, 18), (2, 49, 49, 384, 27), (3, 33, 70, 7, 5),
    (1, 100, 300, 240, 144), (2, 65, 256, 16, 256), (1, 1, 1, 4, 1),
    *TILE_SHAPES,
]


@pytest.mark.parametrize("b,n,m,d,kd", DIGC_CASES)
def test_digc_topk_kernel_matches_plain(cuda, b, n, m, d, kd):
    x = _t(testing.features(n + kd, b, n, d), cuda)
    y = _t(testing.features(m + d, b, m, d), cuda)
    dist, idx = digc_topk_cuda(x, y, kd)
    ref_d, ref_i = digc_topk_plain(x, y, kd)
    torch.cuda.synchronize()
    testing.assert_topk_match(idx.cpu(), dist.cpu(), ref_i.cpu(),
                              ref_d.cpu(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kd", [1, 9, 64, 200])
def test_digc_topk_kernel_exact_ties_lowest_index(cuda, kd):
    x, y = testing.tied_inputs(kd, 2, 70, 230, 12)
    dist, idx = digc_topk_cuda(_t(x, cuda), _t(y, cuda), kd)
    ref_d, ref_i = digc_topk_plain(_t(x, cuda), _t(y, cuda), kd)
    torch.cuda.synchronize()
    assert torch.equal(idx.cpu(), ref_i.cpu())
    assert torch.equal(dist.cpu(), ref_d.cpu())


def test_digc_topk_kernel_rejects_what_it_cannot_take(cuda):
    x = torch.randn(1, 10, 8, device=cuda)
    y = torch.randn(1, 300, 8, device=cuda)
    with pytest.raises(ValueError, match="MAX_KD"):
        digc_topk_cuda(x, y, 257)
    with pytest.raises(TypeError):
        digc_topk_cuda(x.double(), y.double(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        digc_topk_cuda(x.transpose(1, 2).contiguous().transpose(1, 2), y, 4)
    with pytest.raises(ValueError, match="is on"):
        digc_topk_cuda(x, y.cpu(), 4)


# variant name -> kernel keywords; "pos" is a per-image bias, "shared" one
# (1, N, M) bias read with batch stride 0.
VARIANTS = {
    "packed": dict(packed=True),
    "mxu_bf16": dict(mxu_bf16=True),
    "packed_bf16": dict(packed=True, mxu_bf16=True),
    "pos": dict(pos_bias="pos"),
    "shared": dict(pos_bias="shared"),
    "causal": dict(causal=True),
    "causal_pos_packed": dict(causal=True, pos_bias="pos", packed=True),
}
# (B, N, M, D, kd): the iso shape, a pyramid stage, ragged edges, the
# KNN-attention shape (heads as the batch) and the tile's edges.
VARIANT_SHAPES = [(2, 196, 196, 192, 18), (2, 784, 196, 96, 9),
                  (3, 33, 70, 7, 5), (4, 2048, 2048, 32, 32), *TILE_SHAPES]


@pytest.mark.parametrize("b,n,m,d,kd", VARIANT_SHAPES)
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_digc_topk_variant_matches_plain(cuda, name, b, n, m, d, kd):
    kw = dict(VARIANTS[name])
    if kw.get("pos_bias") == "pos":
        kw["pos_bias"] = _t(testing.features(n * m, b, n, m), cuda)
    elif kw.get("pos_bias") == "shared":
        side = int(round(n ** 0.5))
        if side * side != n or n != m:
            pytest.skip("the shared grid bias needs a square self-graph")
        kw["pos_bias"] = grid_pos_bias(side, side, scale=4.0, device=cuda)[None]
    x = _t(testing.features(n + kd, b, n, d), cuda)
    y = _t(testing.features(m + d, b, m, d), cuda)
    reset_launch_counts()
    dist, idx = digc_topk_cuda(x, y, kd, **kw)
    ref_d, ref_i = digc_topk_plain(x, y, kd, **kw)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["digc_topk"] == 1
    for v in ("packed", "mxu_bf16", "causal"):
        assert counts[f"digc_topk.{v}"] == int(kw.get(v, False))
    assert counts["digc_topk.pos_bias"] == int("pos_bias" in kw)
    live = ref_d < BIG / 2
    assert torch.equal(dist >= BIG / 2, ~live)
    assert ((idx >= 0) & (idx < m)).all()
    assert torch.equal(idx[~live], ref_i[~live])
    assert torch.equal(dist[~live], ref_d[~live])
    rtol = RTOL + (2.0 ** (idx_bits_for(m) - 23) if kw.get("packed") else 0.0)
    fill = -1 - torch.arange(kd, dtype=torch.int32, device=cuda)  # distinct
    testing.assert_topk_match(torch.where(live, idx, fill).cpu(),
                              torch.where(live, dist, 0).cpu(),
                              torch.where(live, ref_i, fill).cpu(),
                              torch.where(live, ref_d, 0).cpu(), rtol=rtol,
                              atol=ATOL + rtol * float(x.square().sum(-1).max()
                                                       + y.square().sum(-1).max()))


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_digc_topk_variant_exact_ties(cuda, name):
    kw = dict(VARIANTS[name])
    x, y = testing.tied_inputs(3, 2, 70, 230, 12)
    if kw.get("pos_bias") is not None:
        p = np.random.default_rng(1).integers(-3, 4, (1 if kw["pos_bias"] ==
                                                      "shared" else 2, 70, 230))
        kw["pos_bias"] = _t(p.astype(np.float32), cuda)
    dist, idx = digc_topk_cuda(_t(x, cuda), _t(y, cuda), 40, **kw)
    ref_d, ref_i = digc_topk_plain(_t(x, cuda), _t(y, cuda), 40, **kw)
    torch.cuda.synchronize()
    assert torch.equal(idx, ref_i)
    assert torch.equal(dist, ref_d)


# (B, N, M, D, k): main-path shapes, D not a multiple of 4 (scalar path),
# one neighbour, more neighbours than a warp's ids (40), rows of one
# vector (D = 4) and of 49 (D = 196).
MRCONV_CASES = [
    (8, 196, 196, 192, 9), (8, 3136, 196, 48, 9), (8, 784, 196, 96, 9),
    (8, 49, 49, 384, 9), (2, 100, 300, 7, 16), (1, 33, 513, 1024, 5),
    (2, 50, 70, 4, 1), (2, 50, 70, 196, 40), (1, 33, 40, 4, 40),
    (3, 40, 90, 196, 1),
]


@pytest.mark.parametrize("b,n,m,d,k", MRCONV_CASES)
def test_mrconv_kernel_bitwise_plain(cuda, b, n, m, d, k):
    x = _t(testing.features(n, b, n, d), cuda)
    y = _t(testing.features(m, b, m, d), cuda)
    ids = testing.neighbour_ids(k, b, n, k, m)
    ids[:, ::7, 0] = -1  # out of range: contributes nothing
    ids[:, ::5, -1] = m
    idx = _t(ids, cuda)
    out = mrconv_cuda(x, y, idx)
    ref = mrconv_plain(x, y, idx)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def test_ops_launch_kernels_and_count(cuda):
    reset_launch_counts()
    x = torch.randn(2, 40, 16, device=cuda)
    idx = ops.digc_topk(x, x, k=4, dilation=2)
    agg = ops.mrconv(x, x, idx)
    torch.cuda.synchronize()
    assert idx.shape == (2, 40, 4) and idx.dtype == torch.int32
    assert agg.shape == x.shape and agg.is_cuda
    counts = launch_counts()
    assert (counts.pop("digc_topk"), counts.pop("mrconv")) == (1, 1)
    assert set(counts.values()) == {0}  # no variant was switched on
    with pytest.raises(TypeError):
        ops.mrconv(x.half(), x.half(), idx)


def test_vig_forward_on_card_matches_cpu(cuda):
    from repro_torch.models import convert, vig

    cfg = vig.VIG_VARIANTS["vig_ti_pyr"].replace(
        image_size=64, embed_dims=(8, 16, 24, 32), depths=(1, 1, 1, 1),
        num_classes=5, k=3,
    )
    params = convert.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                 device="cpu")
    imgs = torch.from_numpy(testing.images(0, 2, 64))
    ref = vig.vig_forward(params, imgs, cfg, digc_impl="cuda")
    reset_launch_counts()
    out = vig.Vig(cfg, params, device=cuda)(imgs.to(cuda))
    torch.cuda.synchronize()
    counts = launch_counts()
    assert (counts["digc_topk"], counts["mrconv"]) == (4, 4)
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_stateful_engine_on_card_matches_bucket_forward_bitwise(cuda):
    """The stateful engine on the kernel tier (chip_smoke.py phase 14 at a
    small size): every request's logits equal, bit for bit, a stateless
    forward of its tick's bucket batch; the state rows pass through; each
    tick launches each kernel once a block; an evicted tenant's rows park
    in pinned host memory."""
    from repro_torch.models import convert, vig
    from repro_torch.serve.engine import VigRequest, VigServeEngine

    cfg = vig.VIG_VARIANTS["vig_ti_iso"].replace(
        image_size=64, embed_dims=(32,), depths=(3,), num_classes=5, k=4)
    params = convert.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                 device=cuda)
    eng = VigServeEngine(cfg, params, digc_impl="cuda", buckets=(1, 2, 4),
                         device=cuda)
    ticks = [["a", "b", "c"], ["a"], ["b", "d"], ["e", "a", "c", "b"]]
    uid = 0
    for tick in ticks:
        reqs = [VigRequest(uid + i, testing.images(uid + i, 1, 64)[0], tenant=t)
                for i, t in enumerate(tick)]
        uid += len(tick)
        for r in reqs:
            eng.submit(r)
        reset_launch_counts()
        eng.step()
        torch.cuda.synchronize()
        counts = launch_counts()
        assert (counts["digc_topk"], counts["mrconv"]) == (3, 3)
        order = sorted(reqs, key=lambda r: eng._tenant_slot[r.tenant])
        imgs = [r.image for r in order]
        imgs += [imgs[0]] * (eng.last_bucket - len(imgs))
        with torch.inference_mode():
            ref = vig.vig_forward(params, _t(np.stack(imgs), cuda), cfg,
                                  digc_impl="cuda").cpu().numpy()
        for i, r in enumerate(order):
            assert np.array_equal(r.logits, ref[i])
    assert eng.slot_row_steps() == {"stage0": [0, 0, 0, 0]}
    parked = eng._parked["d"].entries["stage0"].row_step
    assert parked.device.type == "cpu" and parked.is_pinned()


# The legacy merge and bucket_rounds: name -> (digc_topk keywords, block_m
# or None for the wrapper's default). The tuner's legacy tiles
# (``LEGACY_TILES``) and the 216-column bucket spec chip_smoke.py serves
# are among them. Bucket cases need block_m % kd == 0: "kd" is the
# largest multiple of kd within ceil_to(M, 128), "216" the largest within
# min(216, ceil_to(M, 128)) (216 itself at kd = 9, 18, 27).
LEGACY_VARIANTS = {
    "legacy": (dict(kernel_merge="legacy"), None),
    "legacy_packed": (dict(kernel_merge="legacy", packed=True), None),
    "legacy_causal": (dict(kernel_merge="legacy", causal=True), None),
    "legacy_causal_packed": (dict(kernel_merge="legacy", causal=True,
                                  packed=True), 64),
    "legacy_bf16_pos": (dict(kernel_merge="legacy", mxu_bf16=True,
                             pos_bias="pos"), 128),
    **{f"legacy_tuner_{bm}{'_packed' if p else ''}": (
        dict(kernel_merge="legacy", block_n=bn, packed=p), bm)
       for bn, bm in LEGACY_TILES for p in (False, True)},
    "bucket1": (dict(packed=True, bucket_rounds=1), "kd"),
    "bucket2": (dict(packed=True, bucket_rounds=2, causal=True), "kd"),
    "bucket2_216": (dict(packed=True, bucket_rounds=2), "216"),
    "bucket3_bf16": (dict(packed=True, bucket_rounds=3, mxu_bf16=True), "kd"),
}
LEGACY_SHAPES = [(2, 196, 196, 192, 18), (2, 784, 196, 96, 9),
                 (3, 33, 70, 7, 5), (2, 40, 40, 8, 16),
                 (4, 2048, 2048, 32, 32), *TILE_SHAPES]


def _legacy_args(b, n, m, d, kd, kw, block_m, dev):
    """Kernel keywords for one case (the wrappers resolve the tiles)."""
    kw = dict(kw)
    if kw.get("pos_bias") == "pos":
        kw["pos_bias"] = _t(testing.features(n * m, b, n, m), dev)
    if block_m in ("kd", "216"):
        top = -(-m // 128) * 128
        block_m = (top if block_m == "kd" else min(216, top)) // kd * kd
    return dict(kw, block_m=block_m)


@pytest.mark.parametrize("b,n,m,d,kd", LEGACY_SHAPES)
@pytest.mark.parametrize("name", sorted(LEGACY_VARIANTS))
def test_digc_topk_legacy_matches_plain(cuda, name, b, n, m, d, kd):
    kw = _legacy_args(b, n, m, d, kd, *LEGACY_VARIANTS[name], cuda)
    x = _t(testing.features(n + kd, b, n, d), cuda)
    y = _t(testing.features(m + d, b, m, d), cuda)
    reset_launch_counts()
    dist, idx = digc_topk_cuda(x, y, kd, **kw)
    ref_d, ref_i = digc_topk_plain(x, y, kd, **kw)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["digc_topk"] == counts["digc_topk.legacy"] == 1
    assert counts["digc_topk.bucket_rounds"] == int("bucket_rounds" in kw)
    # BIG, pad and INT_BIG lanes equal bit for bit, indices included.
    live = ref_d < BIG / 2
    assert torch.equal(dist >= BIG / 2, ~live)
    assert torch.equal(idx[~live], ref_i[~live])
    assert torch.equal(dist[~live], ref_d[~live])
    rtol = RTOL + (2.0 ** (idx_bits_for(m) - 23) if kw.get("packed") else 0.0)
    fill = -1 - torch.arange(kd, dtype=torch.int32, device=cuda)  # distinct
    testing.assert_topk_match(torch.where(live, idx, fill).cpu(),
                              torch.where(live, dist, 0).cpu(),
                              torch.where(live, ref_i, fill).cpu(),
                              torch.where(live, ref_d, 0).cpu(), rtol=rtol,
                              atol=ATOL + rtol * float(x.square().sum(-1).max()
                                                       + y.square().sum(-1).max()))


@pytest.mark.parametrize("name", sorted(LEGACY_VARIANTS))
def test_digc_topk_legacy_exact_ties(cuda, name):
    b, n, m, d, kd = 2, 70, 230, 12, 40
    kw = _legacy_args(b, n, m, d, kd, *LEGACY_VARIANTS[name], cuda)
    if kw.get("pos_bias") is not None:
        p = np.random.default_rng(1).integers(-3, 4, (b, n, m))
        kw["pos_bias"] = _t(p.astype(np.float32), cuda)
    x, y = testing.tied_inputs(3, b, n, m, d)
    dist, idx = digc_topk_cuda(_t(x, cuda), _t(y, cuda), kd, **kw)
    ref_d, ref_i = digc_topk_plain(_t(x, cuda), _t(y, cuda), kd, **kw)
    torch.cuda.synchronize()
    assert torch.equal(idx, ref_i)
    assert torch.equal(dist, ref_d)

