# NOTE: do NOT set XLA_FLAGS / device-count here — unit and smoke tests
# must see the single real CPU device. Multi-device tests spawn
# subprocesses with their own flags (test_ring.py, test_dryrun.py).

import os


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card (skips where there is none)"
    )
    # Fixed hypothesis profile (CI fast job + local runs): no deadline —
    # jit compiles inside property bodies blow any wall-clock budget —
    # and derandomized so every run draws the same examples (the serve
    # property tests must be reproducible across CI shards). Override
    # with HYPOTHESIS_PROFILE=default for exploratory fuzzing.
    try:
        from hypothesis import settings
    except ImportError:
        return
    settings.register_profile("repro", deadline=None, derandomize=True)
    settings.load_profile(os.environ.get("HYPOTHESIS_PROFILE", "repro"))
