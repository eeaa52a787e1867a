"""Seconds of set-up inside the program after the pool: make_reset (on a
checkout's first run nvcc's build of the observation kernel among it),
make_step (the observations over the pool's maps and the reset template
among it) and the first reset (the program's ``setup.make_reset``,
``setup.make_step`` and ``setup.reset`` spans, host_totals.py)."""

from gridbench.metrics import host_totals

SPANS = ("setup.make_reset", "setup.make_step", "setup.reset")


def read(ctx):
    return host_totals.seconds(host_totals.totals(), SPANS)
