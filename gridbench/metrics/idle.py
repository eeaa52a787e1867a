"""The device's idle share of a step: the arithmetic of mettagrid_tpu_torch's
tools/profile_step.py (as of this benchmark's first version), without its
clamp at 0."""


def idle_share(busy_ms_per_step: float, untraced_ms_per_step: float) -> float:
    """1 - (profiler busy ms per step) / (untraced ms per step, measured just
    before the trace in the same process)."""
    return 1.0 - busy_ms_per_step / untraced_ms_per_step
