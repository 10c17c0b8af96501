"""The family contract (``families/__init__.py``): every family that
``BENCHMARK.json`` names provides it, and ``control.readings``, which
reads the controls from the family, gives the ViG cells today's keys
and readings on the CPU at a small size."""

import json
from pathlib import Path

import pytest

from vigbench import control, families, harness
from vigbench.test_vigbench_harness import small_cell

HERE = Path(__file__).resolve().parent
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
NAMED = sorted({json.loads((HERE.parent / c["file"]).read_text())["family"]
                for c in BENCH["configs"]})
VIG_KEYS = {"seed", "requests", "reference_s", "program", "control_tf32",
            "upper_lanes_other", "upper_lanes_zero"}
VIG_HELD = {"missing", "gap_q25_worst_lane", "lanes_held", "least_answers_in_a_lane",
            "gap_q25", "gap_median", "gap_q75", "gap_max"}


@pytest.mark.parametrize("name", NAMED)
def test_every_named_family_keeps_the_contract(name):
    family = harness.load_family(name)
    missing = [n for n in families.CONTRACT if not hasattr(family, n)]
    assert not missing, f"families/{name}.py lacks {missing}"
    assert all(callable(getattr(family.System, n)) for n in families.SYSTEM)
    assert family.CONTROL_BREAKS and all(
        isinstance(v, str) for v in family.CONTROL_BREAKS.values())


def test_vig_readings_keep_todays_keys_and_assertions():
    cfg, mix, limits = small_cell("vig_ti_iso", "poisson_iso224")
    out = control.readings(cfg, mix, limits, 2**31 + 7, 0.5, "cpu")
    assert set(out) == VIG_KEYS
    assert all(set(out[k]) == VIG_HELD for k in VIG_KEYS - {"seed", "requests",
                                                             "reference_s"})
    json.dumps(out)
    held = limits["gap_q25_worst_lane"]
    assert out["program"]["missing"] == 0
    assert out["program"]["gap_q25_worst_lane"] <= held
    assert out["control_tf32"]["gap_q25_worst_lane"] > held
    assert out["upper_lanes_other"]["gap_q25_worst_lane"] > held
    assert out["upper_lanes_zero"]["gap_q25_worst_lane"] > held
    family = harness.load_family(cfg["family"])
    assert set(family.CONTROL_BREAKS) == VIG_KEYS - {"seed", "requests", "reference_s",
                                                     "program"}
