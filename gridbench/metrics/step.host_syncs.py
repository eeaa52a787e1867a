"""Device values read on the host per untraced step (the program's counter
``host_syncs`` over ``step.calls``, host_totals.py): each read drains the
queue and leaves the device waiting while the host issues what follows."""

from gridbench.metrics import host_totals


def read(ctx):
    return host_totals.count_per_step(host_totals.totals(), "host_syncs")
