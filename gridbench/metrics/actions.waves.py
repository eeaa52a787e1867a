"""Waves of the action phase per untraced step (the program's counter
``actions.waves`` over ``step.calls``, host_totals.py)."""

from gridbench.metrics import host_totals


def read(ctx):
    return host_totals.count_per_step(host_totals.totals(), "actions.waves")
