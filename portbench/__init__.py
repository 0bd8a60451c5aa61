"""The benchmark of ``repro_torch``'s serving path (``BENCHMARK.json``).

``portbench/run.py`` runs one cell; ``harness/`` is the general code
(traffic generation, the serving window, the trace reading, the output
check), ``configs/``, ``traffic/``, ``cells/`` and ``metrics/`` hold what
belongs to one configuration, mix, cell or metric, found by name, and
``reference/`` the plain float32 forwards that decide ``correct``.
"""
