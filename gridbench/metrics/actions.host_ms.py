"""Host ms per untraced step in the ``step.actions`` span less its child
spans, its host reads' waits among them (host_totals.py)."""

from gridbench.metrics import host_totals


def read(ctx):
    return host_totals.self_ms(host_totals.totals(), "step.actions")
