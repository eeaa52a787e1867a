"""Per-layer metric readers and the yardstick they share.

``<metric>.py`` (the metric's name, dots and all) holds ``read(ctx)``, which
returns the metric's value or None where the run has nothing to read; the
harness finds it by the name in BENCHMARK.json. ``spans.py``, ``idle.py``,
``obs_bytes.py`` and ``peaks.py`` are the frozen arithmetic the readers use,
so a change to the program's own copies does not move the yardstick.
"""
