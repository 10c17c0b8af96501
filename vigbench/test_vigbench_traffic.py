"""The frozen traffic generator: deterministic per seed, different across
seeds, and the same amount of work for every seed."""

import numpy as np
import pytest

from vigbench import traffic

MIX = {"loop": "open", "rate_per_s": 500, "burst_share": 0.25, "burst_size": 16,
       "arrival_seed": 0}
BIG_SEED = 2**31 + 12345


def test_open_schedule_is_identical_for_one_seed():
    a = traffic.open_schedule(MIX, 4.0, BIG_SEED, 64)
    b = traffic.open_schedule(MIX, 4.0, BIG_SEED, 64)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_seeds_share_the_arrivals_and_differ_in_images():
    due1, img1 = traffic.open_schedule(MIX, 4.0, 1, 64)
    due2, img2 = traffic.open_schedule(MIX, 4.0, 2, 64)
    assert len(due1) == 2000
    np.testing.assert_array_equal(due1, due2)
    assert not np.array_equal(img1, img2)
    assert np.all(np.diff(due1) >= 0)
    assert 0.0 <= due1.min() and due1.max() < 4.0 + 1e-3
    other = traffic.open_schedule(dict(MIX, arrival_seed=1), 4.0, 1, 64)[0]
    assert not np.array_equal(due1, other)


def test_open_schedule_bursts_and_rate():
    due, img = traffic.open_schedule(MIX, 10.0, 7, 64)
    gaps = np.diff(due)
    in_burst = np.isclose(gaps, traffic.BURST_SPACING_S)
    # 25% of 5000 requests in bursts of 16: 78 bursts, 15 in-burst gaps
    # each, less the few that a Poisson arrival splits.
    assert len(due) == 5000
    assert 78 * 15 - 20 <= in_burst.sum() <= 78 * 15
    assert img.min() >= 0 and img.max() < 64


@pytest.mark.parametrize("seconds", [1.0, 20.0])
def test_quantile_times_fill_the_window(seconds):
    t = traffic._quantile_times(100, seconds, np.random.default_rng(0))
    assert t[0] == 0.0 and t[-1] < seconds
    gaps_a = np.sort(np.diff(np.append(t, seconds)))
    t2 = traffic._quantile_times(100, seconds, np.random.default_rng(1))
    gaps_b = np.sort(np.diff(np.append(t2, seconds)))
    np.testing.assert_allclose(gaps_a, gaps_b, rtol=1e-9)


def test_closed_draws_are_seeded():
    a = traffic.closed_items(BIG_SEED, 64, 1000)
    np.testing.assert_array_equal(a, traffic.closed_items(BIG_SEED, 64, 1000))
    assert not np.array_equal(a, traffic.closed_items(BIG_SEED + 1, 64, 1000))
