"""On the card: the control and the broken lanes at each configuration's
size. The program's answers pass the limits; the reference computed in
TF32, put in the program's place, fails them, and so do the program's
answers with the upper half of every bucket's lanes wrong, on three
seeds. Run on a card with

    PYTHONPATH=src python -m pytest -q -m gpu vigbench/test_vigbench_gpu.py
"""

import json
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_the_limits_at_the_cells_size(card, workload):
    from vigbench import control, harness

    cell, conf = harness.find_cell(BENCH, workload)
    cfg = harness.load_json(HERE.parent / conf["file"])
    mix = harness.load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = harness.load_json(HERE / "limits" / f"{conf['name']}.json")
    held = limits["gap_q25_worst_lane"]
    for seed in (7001, 7002, 7003):
        out = control.readings(cfg, mix, limits, seed, 2.0, card)
        assert out["program"]["missing"] == 0
        assert out["program"]["gap_q25_worst_lane"] <= held
        assert out["control_tf32"]["gap_q25_worst_lane"] > held
        assert out["upper_lanes_other"]["gap_q25_worst_lane"] > held
        assert out["upper_lanes_zero"]["gap_q25_worst_lane"] > held
