"""The benchmark harness of ``repro_torch``: its data plane and its LM
serving engine.

``run.py`` beside this package is the one entry point.  Everything that
belongs to one configuration, one traffic mix, one metric or one kind of
run is a file of its own under ``configs/``, ``traffic/``, ``metrics/`` and
``runners/``, found by the name ``BENCHMARK.json`` gives it; this package
is the general machinery, the data plane's runner and the frozen yardstick
(packet layout, RSS hash, peaks, work counts).  It imports nothing of the
program at import time: the runners import ``repro_torch`` inside
``run_cell``.
"""
