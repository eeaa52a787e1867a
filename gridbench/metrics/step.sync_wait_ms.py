"""Host ms per untraced step spent waiting in the step's host reads (the
program's ``sync.*`` spans, host_totals.py)."""

from gridbench.metrics import host_totals


def read(ctx):
    return host_totals.sync_wait_ms(host_totals.totals())
