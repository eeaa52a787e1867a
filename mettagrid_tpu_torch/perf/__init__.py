"""Performance harness (reference: mettagrid_tpu/perf/)."""

from mettagrid_tpu_torch.perf.harness import PerfResult, run_performance

__all__ = ["PerfResult", "run_performance"]
