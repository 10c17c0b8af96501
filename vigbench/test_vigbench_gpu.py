"""On the card: each family's controls at each configuration's size.
The program's held numbers pass their limits with no answer missing;
each of the family's controls (``family.controls``: for the ViG family
the reference computed in TF32, put in the program's place, and the
program's answers with the upper half of every bucket's lanes wrong)
exceeds the limit that ``family.CONTROL_BREAKS`` names, on three seeds.
Run on a card with

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
    family = harness.load_family(cfg["family"])
    for seed in (7001, 7002, 7003):
        out = control.readings(cfg, mix, limits, seed, 2.0, card)
        program = out["program"]
        assert program["missing"] == 0
        for name in program.keys() & limits.keys():
            assert program[name] <= limits[name], (seed, name)
        for name, number in family.CONTROL_BREAKS.items():
            assert out[name][number] > limits[number], (seed, name)
