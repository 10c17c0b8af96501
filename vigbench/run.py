"""Run one cell of the benchmark and print its result as one JSON line.

    python vigbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs from the root of a checkout and needs a CUDA card: without one (or
with fewer than the cell asks for) it exits with code 2 and prints no
result. ``--trace 1`` reports the cell's per-layer metrics from a
profiled slice of the window (its trace goes to ``results/vigbench/``),
``--trace 0`` its end-to-end metrics.
"""

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
# The port's libraries load no JAX: keep transformers' optional backends off.
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
# One process, one CPU thread: the host is shared, and the serving loop
# is single-threaded Python around the card.
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(var, "1")

from vigbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_PROCESS))
