"""Object slots the observations encode through stage 1 per untraced step
(the program's counter ``obs.stage1_slots`` over ``step.calls``,
host_totals.py): E·N where every object is encoded each step, E·A where a
static background is encoded once per pool map. Nothing where the program
does not count them."""

from gridbench.metrics import host_totals

COUNTER = "obs.stage1_slots"


def read(ctx):
    t = host_totals.totals()
    return host_totals.count_per_step(t, COUNTER) if COUNTER in t else None
