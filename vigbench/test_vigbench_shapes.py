"""The frozen shape arithmetic: hand counts at small shapes, and the
plans of the configurations against the program's own."""

import json
from pathlib import Path

import pytest

from vigbench import shapes

HERE = Path(__file__).resolve().parent


def small_iso():
    return {"image_size": 32, "patch": 8, "in_chans": 3, "embed_dims": [8],
            "depths": [5], "reduce_ratios": [1], "k": 3, "max_dilation": 4,
            "use_dilation": True, "ffn_ratio": 4, "num_classes": 10}


def small_pyr():
    return {"image_size": 64, "patch": 4, "in_chans": 3,
            "embed_dims": [4, 8, 12, 16], "depths": [1, 1, 1, 1],
            "reduce_ratios": [4, 2, 1, 1], "k": 3, "max_dilation": 4,
            "use_dilation": True, "ffn_ratio": 4, "num_classes": 10}


def test_digc_and_mrconv_counts_by_hand():
    cfg = small_iso()
    calls = shapes.digc_calls(cfg, 2)
    assert [c["kd"] for c in calls] == [3, 3, 3, 3, 6]  # block 4 dilates by 2
    c = calls[0]
    assert (c["b"], c["n"], c["m"], c["d"]) == (2, 16, 16, 8)
    # 2 b n m d = 8192 operations; x and y read once (4 * 2 * 32 * 8 bytes)
    # and kd indices and distances written once (8 * 2 * 16 * 3).
    assert shapes.digc_least_s(c) == max(8192 / 495e12, (2048 + 768) / 3.35e12)
    m = shapes.mrconv_calls(cfg, 2)[4]
    assert (m["k"], m["n"], m["m"]) == (3, 16, 16)
    # subtract + max per (node, neighbour, feature): 2 * 2 * 16 * 3 * 8;
    # x and y and the output 4 * 2 * (16 + 16 + 16) * 8, indices 4 * 2 * 16 * 3.
    assert shapes.mrconv_least_s(m) == max(1536 / 67e12, (3072 + 384) / 3.35e12)


def test_model_flops_by_hand():
    # iso: stem 2*16*192*8, five blocks of 2*16*64*(1+2+1+8) + DIGC
    # 2*16*16*8, head 2*8*10.
    assert shapes.model_flops_per_image(small_iso()) == 49152 + 5 * 28672 + 160
    # pyramid: stem, four stages (GEMMs + DIGC), three downsamples, head.
    expect = (98304 + (98304 + 32768) + 16384 + (98304 + 16384) + 12288
              + (55296 + 6144) + 6144 + (24576 + 512) + 320)
    assert shapes.model_flops_per_image(small_pyr()) == expect


def test_pyramid_plans_by_hand():
    plans = shapes.stage_plans(small_pyr())
    assert [(p["n"], p["m"], p["dim"]) for p in plans] == [
        (256, 16, 4), (64, 16, 8), (16, 16, 12), (4, 4, 16)]
    assert plans[3]["blocks"] == [(1, 3)]


@pytest.mark.parametrize("name", ["vig_ti_iso", "vig_ti_pyr"])
def test_plans_match_the_program(name):
    from repro_torch.models.vig import VigConfig, vig_stage_plans

    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    vcfg = VigConfig(
        name=name, variant=cfg["variant"], image_size=cfg["image_size"],
        patch=cfg["patch"], embed_dims=tuple(cfg["embed_dims"]),
        depths=tuple(cfg["depths"]), reduce_ratios=tuple(cfg["reduce_ratios"]),
        k=cfg["k"], max_dilation=cfg["max_dilation"], num_classes=cfg["num_classes"])
    ours = shapes.stage_plans(cfg)
    theirs = vig_stage_plans(vcfg, "cuda")
    assert [(p["n"], p["m"]) for p in ours] == [(p.n, p.m) for p in theirs]
    assert [[b[0] for b in p["blocks"]] for p in ours] == [list(p.dilations) for p in theirs]
    assert [[b[1] for b in p["blocks"]] for p in ours] == [list(p.k_effs) for p in theirs]


def test_paper_work_per_image():
    iso = json.loads((HERE / "configs" / "vig_ti_iso.json").read_text())
    pyr = json.loads((HERE / "configs" / "vig_ti_pyr.json").read_text())
    pairs = lambda cfg: sum(c["n"] * c["m"] for c in shapes.digc_calls(cfg, 1))
    assert pairs(iso) == 12 * 196 * 196
    assert pairs(pyr) == 2 * 3136 * 196 + 2 * 784 * 196 + 6 * 196 * 196 + 2 * 49 * 49
