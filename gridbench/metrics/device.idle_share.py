"""The device's idle share of a step (idle.idle_share): 1 - the profiler's
busy ms per step over the untraced ms per step of the window just before."""

from gridbench.metrics.idle import idle_share


def read(ctx):
    trace = ctx.get("trace")
    if not trace or trace["busy_s"] <= 0 or not ctx.get("untraced_ms_per_step"):
        return None
    return idle_share(trace["busy_s"] * 1e3 / trace["steps"], ctx["untraced_ms_per_step"])
