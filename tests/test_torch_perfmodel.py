"""The port's cost models (``repro_torch.core.perfmodel``) against the JAX
package's: the paper's FPGA cycle model, the traffic and FLOP counts and
the CPU engine prior are pure integer/float functions and must be equal;
the Hopper estimate and tile defaults are the port's own and are checked
for their fields, budgets and ranking."""

import itertools

import pytest

torch = pytest.importorskip("torch")

from repro.core import perfmodel as jperf  # noqa: E402
from repro_torch.core import perfmodel  # noqa: E402
from repro_torch.core.tuner import DigcTuner  # noqa: E402

SHAPES = [(196, 196, 192, 8), (3136, 196, 48, 9), (784, 196, 96, 18),
          (49, 49, 384, 27), (12544, 12544, 96, 9), (100, 37, 7, 3)]


@pytest.mark.parametrize("n,m,d,k", SHAPES)
def test_fpga_model_and_counts_equal_jax(n, m, d, k):
    assert perfmodel.fpga_cycles(n, m, d, k) == jperf.fpga_cycles(n, m, d, k)
    cfg = perfmodel.FPGAConfig(p_row=7, p_sort=14, q=4)
    jcfg = jperf.FPGAConfig(p_row=7, p_sort=14, q=4)
    assert perfmodel.fpga_cycles(n, m, d, k, cfg) == jperf.fpga_cycles(
        n, m, d, k, jcfg)
    assert perfmodel.fpga_latency_ms(n, m, d, k, 300e6) == \
        jperf.fpga_latency_ms(n, m, d, k, 300e6)
    assert perfmodel.digc_flops(n, m, d) == jperf.digc_flops(n, m, d)
    for block_n, streaming, pos, nbytes in itertools.product(
            (16, 128), (True, False), (True, False), (2, 4)):
        kw = dict(block_n=block_n, streaming=streaming, with_pos_bias=pos,
                  dtype_bytes=nbytes)
        assert perfmodel.digc_hbm_bytes(n, m, d, k, **kw) == \
            jperf.digc_hbm_bytes(n, m, d, k, **kw)
    assert perfmodel.pallas_tile_defaults(n, m, d, k) == \
        jperf.kernel_tile_defaults(n, m, d, k)


def test_paper_table_one():
    assert perfmodel.fpga_cycles(196, 196, 192, 16) == \
        jperf.fpga_cycles(196, 196, 192, 16)
    assert perfmodel.fpga_cycles(196, 196, 192, 8)["DCM"] == 4704


@pytest.mark.parametrize("res,patch,red", [(224, 16, 1), (224, 4, 1),
                                           (224, 4, 4), (512, 16, 2)])
def test_resolution_to_nodes_equal_jax(res, patch, red):
    assert perfmodel.vig_resolution_to_nodes(res, patch, red) == \
        jperf.vig_resolution_to_nodes(res, patch, red)


@pytest.mark.parametrize("n,m,d,k", SHAPES[:4] + SHAPES[5:])
@pytest.mark.parametrize("merge", ["select", "topk", "packed"])
def test_engine_cost_cpu_equals_jax(n, m, d, k, merge):
    for b, bn, bm, fuse in itertools.product(
            (1, 8), (None, 64, 256), (None, 128, 512), (False, True)):
        kw = dict(b=b, block_n=bn, block_m=bm, merge=merge, fuse_norms=fuse,
                  backend="cpu")
        assert perfmodel.engine_cost_estimate(n, m, d, k, **kw) == \
            jperf.engine_cost_estimate(n, m, d, k, **kw)


def test_engine_cost_cpu_penalizes_oversized_tiles():
    huge = perfmodel.engine_cost_estimate(12544, 12544, 96, 9, b=2,
                                          block_m=12544, backend="cpu")
    assert huge == jperf.engine_cost_estimate(12544, 12544, 96, 9, b=2,
                                              block_m=12544, backend="cpu")
    assert huge["spill_s"] > 0.0


@pytest.mark.parametrize("merge,rounds,packed", [
    ("bitonic", 0, False), ("legacy", 0, False), ("legacy", 0, True),
    ("legacy", 2, True)])
def test_h100_estimate_fields(merge, rounds, packed):
    est = perfmodel.h100_digc_estimate(196, 196, 192, 9, 2, block_m=252,
                                       kernel_merge=merge, packed=packed,
                                       bucket_rounds=rounds)
    assert set(est) >= {"flops", "compute_s", "hbm_bytes", "memory_s",
                        "merge_s", "bound", "latency_s", "naive_hbm_bytes",
                        "traffic_saving"}
    assert est["latency_s"] == max(est["compute_s"], est["memory_s"],
                                   est["merge_s"]) > 0
    assert est["compute_s"] == 2 * 196 * 196 * 192 / 67e12
    assert est["traffic_saving"] == est["naive_hbm_bytes"] / est["hbm_bytes"]
    cfg = perfmodel.H100Config()
    assert cfg.lane_ops == 132 * 64 * 1.98e9


def test_h100_merge_work_grows_with_kd_for_legacy_only():
    def merge_s(km, kd):
        return perfmodel.h100_digc_estimate(196, 196, 192, kd, 1,
                                            kernel_merge=km)["merge_s"]
    assert merge_s("legacy", 27) > 2 * merge_s("legacy", 9)
    assert merge_s("bitonic", 27) < 1.2 * merge_s("bitonic", 9)


@pytest.mark.parametrize("n,m,d,kd", [(196, 196, 192, 18), (3136, 196, 48, 9),
                                      (2048, 2048, 32, 256), (49, 49, 384, 27)])
def test_kernel_tile_defaults_fit_shared_memory(n, m, d, kd):
    assert perfmodel.kernel_tile_defaults(n, m, d, kd) == (
        perfmodel.CUDA_BLOCK_N, perfmodel.CUDA_CHUNK_M)
    for key_bytes in (4, 8):
        buf = perfmodel.cuda_merge_buffer(kd, key_bytes)
        smem = (perfmodel.CUDA_STATIC_SMEM
                + perfmodel.cuda_dynamic_smem(kd, buf, key_bytes, True))
        assert smem * perfmodel.CUDA_BLOCKS_PER_SM <= perfmodel.H100Config(
        ).smem_per_sm


def test_kernel_prior_penalizes_plain_version_off_card():
    """On the CPU a cuda candidate runs the kernel's plain version: its
    prior must rank below every plausible engine schedule, while on the
    card the Hopper estimate ranks it ahead of the eager engine."""
    cpu = perfmodel.kernel_cost_estimate(3136, 3136, 96, 9, b=2)
    assert cpu["plain"] and cpu["bound"] == "plain"
    eng = perfmodel.engine_cost_estimate(3136, 3136, 96, 9, b=2, block_m=512,
                                         backend="cpu")
    assert cpu["total_s"] > eng["total_s"]
    card = perfmodel.kernel_cost_estimate(3136, 3136, 96, 9, b=2,
                                          backend="cuda",
                                          kernel_merge="legacy")
    assert not card["plain"]
    eng_card = perfmodel.engine_cost_estimate(3136, 3136, 96, 9, b=2,
                                              block_m=512, backend="cuda")
    assert card["total_s"] < eng_card["total_s"]


@pytest.mark.parametrize("backend", ["cpu", "cuda"])
def test_cuda_configs_rank_by_backend(backend):
    """Mirror of tests/test_tuner.py::test_kernel_config_ranks_last_on_cpu:
    last on the CPU; on a card both merges lead the ranking, so the
    measured top-N launches the legacy merge."""
    t = DigcTuner(backend=backend)
    ranked = t.rank(t.candidates(1024, 1024, d=64, kd=8),
                    b=1, n=1024, m=1024, d=64, kd=8)
    n_kernel = sum(1 for c in ranked if c.impl == "cuda")
    assert n_kernel > 0
    if backend == "cpu":
        assert all(c.impl == "cuda" for c in ranked[-n_kernel:])
    else:
        assert all(c.impl == "cuda" for c in ranked[:n_kernel])
        assert {c.kernel_merge for c in ranked[:t.max_measure]
                if c.impl == "cuda"} == {"bitonic", "legacy"}


@pytest.mark.parametrize("merge", ["bitonic", "legacy"])
def test_card_kernel_prior_adds_the_fitted_call_cost(merge):
    """On the card a kernel call costs its device estimate plus the fitted
    fixed per-call term, the same for both merges; ``call_s=0`` reads the
    device estimate alone."""
    kw = dict(b=8, block_m=256 if merge == "legacy" else 64,
              kernel_merge=merge, backend="cuda")
    est = perfmodel.kernel_cost_estimate(196, 196, 192, 18, **kw)
    dev = perfmodel.kernel_cost_estimate(196, 196, 192, 18, call_s=0.0, **kw)
    assert est["call_s"] == perfmodel._CUDA_KERNEL_CALL_S > 0
    assert dev["total_s"] == dev["device_s"] == est["device_s"]
    assert est["total_s"] == pytest.approx(est["device_s"] + est["call_s"])
    assert perfmodel._ENGINE_CONSTANTS["cuda"]["tile"] > 0
    assert not any(perfmodel._ENGINE_CONSTANTS["cuda"][t]
                   for t in ("gemm", "topk", "lane", "byte"))
