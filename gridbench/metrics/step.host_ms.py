"""Host ms per untraced step in the step call less its host reads' waits:
the host's own work of issuing the step (host_totals.py)."""

from gridbench.metrics import host_totals


def read(ctx):
    return host_totals.step_host_ms(host_totals.totals())
