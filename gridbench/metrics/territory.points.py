"""(point, emitting source) pairs whose influence is scored per untraced step
(the program's counter ``territory.points`` over ``step.calls``,
host_totals.py): the agents' cells in the territory phase and every cell for
the AOE mask, each times the emitters read back. Nothing where the program
does not count them."""

from gridbench.metrics import host_totals

COUNTER = "territory.points"


def read(ctx):
    t = host_totals.totals()
    return host_totals.count_per_step(t, COUNTER) if COUNTER in t else None
