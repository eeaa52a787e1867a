"""Profiling utilities (reference: mettagrid_tpu/profiling/)."""

from mettagrid_tpu_torch.profiling.monitor import MemoryMonitor, SystemMonitor
from mettagrid_tpu_torch.profiling.phase_timing import measure_step_phases
from mettagrid_tpu_torch.profiling.stopwatch import Stopwatch

__all__ = ["MemoryMonitor", "Stopwatch", "SystemMonitor", "measure_step_phases"]
