"""The serving benchmark of ``repro_torch`` on an NVIDIA H100.

``python vigbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line. Everything a cell needs is found by name: its configuration in
``configs/<config>.json``, its traffic mix in ``traffic/<traffic>.json``,
each metric's reader in ``metrics/<metric>.py``, the model family's
glue in ``families/<family>.py`` and the correctness limits in
``limits/<config>.json``. The plain reference (``reference/``), the
traffic generator (``traffic.py``) and the shape arithmetic behind the
roofline and MFU counts (``shapes.py``) are frozen here, apart from the
program under test.
"""
