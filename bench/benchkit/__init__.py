"""The benchmark harness of the ``repro_torch`` data plane.

``run.py`` beside this package is the one entry point.  Everything that
belongs to one configuration, one traffic mix or one metric is a file of
its own under ``configs/``, ``traffic/`` and ``metrics/``, found by the
name ``BENCHMARK.json`` gives it; this package is the general machinery
and the frozen yardstick (packet layout, RSS hash, peaks, work counts).
It imports nothing of the program at import time: ``runner`` imports
``repro_torch`` inside ``run_cell``.
"""
