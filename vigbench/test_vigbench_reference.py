"""The plain reference against the port's CPU path at small sizes (the
port is imported here only, in the test), its TF32 rounding, and the
control's separation from the program at a size a test run holds."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from vigbench.families import vig as family
from vigbench.reference import vig_plain

HERE = Path(__file__).resolve().parent


def small(name):
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    if cfg["variant"] == "isotropic":
        cfg.update(image_size=64, patch=8, embed_dims=[24], depths=[5], num_classes=10)
    else:
        cfg.update(image_size=64, embed_dims=[8, 16, 24, 32], depths=[1, 1, 2, 1],
                   num_classes=10)
    cfg.update(pool_images=6, reference_block=4)
    return cfg


def vig_config(cfg):
    from repro_torch.models.vig import VigConfig

    return VigConfig(
        name=cfg["name"], variant=cfg["variant"], image_size=cfg["image_size"],
        patch=cfg["patch"], embed_dims=tuple(cfg["embed_dims"]),
        depths=tuple(cfg["depths"]), reduce_ratios=tuple(cfg["reduce_ratios"]),
        k=cfg["k"], max_dilation=cfg["max_dilation"], num_classes=cfg["num_classes"],
        ffn_ratio=cfg["ffn_ratio"])


@pytest.mark.parametrize("name", ["vig_ti_iso", "vig_ti_pyr"])
@pytest.mark.parametrize("tier", ["cuda", "reference"])
def test_reference_matches_the_port_on_the_cpu(name, tier):
    from repro_torch.models.vig import vig_forward

    cfg = small(name)
    weights, pool, _ = family.setup(cfg, 3, "cpu")
    ref = vig_plain.forward(weights, pool, cfg)
    with torch.inference_mode():
        out = vig_forward(family._unflatten(weights), pool, vig_config(cfg),
                          digc_impl=tier)
    scale = float(ref.abs().max())
    assert float((out - ref).abs().max()) <= 1e-5 * scale


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    r = vig_plain._tf32(x)
    bits = r.view(torch.int32)
    assert int((bits & 0x1FFF).abs().sum()) == 0
    rel = ((r - x).abs() / x.abs()).max()
    assert 0 < float(rel) <= 2.0**-11


def test_reference_rejects_unknown_arithmetic():
    cfg = dict(small("vig_ti_iso"), act="gelu_erf")
    weights, pool, _ = family.setup(cfg, 3, "cpu")
    with pytest.raises(ValueError, match="gelu_tanh"):
        vig_plain.forward(weights, pool, cfg)


def test_reference_is_seeded_and_independent_of_the_program():
    cfg = small("vig_ti_pyr")
    a = vig_plain.forward(*family.setup(cfg, 5, "cpu")[:2], cfg)
    b = vig_plain.forward(*family.setup(cfg, 5, "cpu")[:2], cfg)
    c = vig_plain.forward(*family.setup(cfg, 6, "cpu")[:2], cfg)
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("name,traffic", [("vig_ti_iso", "poisson_iso224"),
                                          ("vig_ti_pyr", "backlog")])
def test_control_fails_where_the_program_passes(name, traffic):
    """The control (the reference in TF32, in the program's place) reads
    a quartile gap at least a hundred times the program's."""
    from vigbench import control

    cfg = small(name)
    mix = json.loads((HERE / "traffic" / f"{traffic}.json").read_text())
    mix = dict(mix, rate_per_s=200)
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    out = control.readings(cfg, mix, limits, 11, 0.3, "cpu")
    prog, ctl = out["program"], out["control_tf32"]
    assert prog["missing"] == 0
    assert ctl["gap_q25_worst_lane"] > 100 * prog["gap_q25_worst_lane"]
    assert np.isfinite(ctl["gap_q25_worst_lane"])
    # The broken lanes are there; whether the check sees them at a cell's
    # size is the card's test (test_vigbench_gpu.py), at this size the
    # harness's (test_vigbench_harness.py).
    assert out["upper_lanes_zero"]["gap_max"] == 1.0
    assert out["upper_lanes_other"]["gap_max"] > 100 * prog["gap_median"]
