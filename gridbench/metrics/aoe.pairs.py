"""(source slot, agent) pairs the AOE phase evaluates per untraced step (the
program's counter ``aoe.pairs`` over ``step.calls``, host_totals.py): E·N·A
for each AOE spec. Nothing where the program does not count them."""

from gridbench.metrics import host_totals

COUNTER = "aoe.pairs"


def read(ctx):
    t = host_totals.totals()
    return host_totals.count_per_step(t, COUNTER) if COUNTER in t else None
