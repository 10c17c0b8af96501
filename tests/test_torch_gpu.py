"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test takes the ``cuda`` fixture, which skips where there is
no card; run them on a GPU host with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances: the kernel sums the distance product in its own order (one
fp32 FMA chain per entry), the plain version in cuBLAS's, so distances
agree to fp32 rounding (rtol 1e-5, atol 1e-4 on distances of order
2*D) and indices agree except at near-ties. MRConv does no arithmetic
beyond one subtraction and a max, so it must agree bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import testing  # noqa: E402
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


# (B, N, M, D, kd): main-path shapes, ragged edges, D off the chunk
# multiple, and the longest lists the kernel keeps.
DIGC_CASES = [
    (1, 196, 196, 192, 9), (8, 196, 196, 192, 27), (2, 3136, 196, 48, 9),
    (2, 784, 196, 96, 18), (2, 49, 49, 384, 27), (3, 33, 70, 7, 5),
    (1, 100, 300, 240, 144), (2, 65, 256, 16, 256), (1, 1, 1, 4, 1),
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


# (B, N, M, D, k): main-path shapes, D not a multiple of 4 (scalar path).
MRCONV_CASES = [
    (8, 196, 196, 192, 9), (8, 3136, 196, 48, 9), (8, 784, 196, 96, 9),
    (8, 49, 49, 384, 9), (2, 100, 300, 7, 16), (1, 33, 513, 1024, 5),
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
    assert launch_counts() == {"digc_topk": 1, "mrconv": 1}
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
    assert launch_counts() == {"digc_topk": 4, "mrconv": 4}
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-4)
