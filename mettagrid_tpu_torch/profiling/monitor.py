"""Memory/system monitors (reference: mettagrid_tpu/profiling/monitor.py):
psutil is optional, and without it the monitors read /proc."""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

try:
    import psutil

    _HAS_PSUTIL = True
except ImportError:  # pragma: no cover
    _HAS_PSUTIL = False


def _proc_status_kb(field: str) -> Optional[int]:
    try:
        with open(f"/proc/{os.getpid()}/status") as f:
            for line in f:
                if line.startswith(field + ":"):
                    return int(line.split()[1])
    except OSError:
        return None
    return None


class MemoryMonitor:
    """Tracks process RSS over time; add() objects for size attribution."""

    def __init__(self):
        self._tracked: Dict[str, Any] = {}
        self._samples: list[tuple[float, float]] = []

    def add(self, name: str, obj: Any) -> None:
        self._tracked[name] = obj

    def rss_mb(self) -> float:
        if _HAS_PSUTIL:
            return psutil.Process().memory_info().rss / 1e6
        kb = _proc_status_kb("VmRSS")
        return (kb or 0) / 1e3

    def sample(self) -> float:
        rss = self.rss_mb()
        self._samples.append((time.time(), rss))
        return rss

    def stats(self) -> Dict[str, Any]:
        import sys

        return {
            "rss_mb": self.rss_mb(),
            "peak_samples_mb": max((s for _, s in self._samples), default=0.0),
            "tracked": {name: sys.getsizeof(obj) for name, obj in self._tracked.items()},
        }


class SystemMonitor:
    """Periodic CPU/memory snapshots (poll() from the training loop)."""

    def __init__(self):
        self._history: list[Dict[str, Any]] = []

    def poll(self) -> Dict[str, Any]:
        snap: Dict[str, Any] = {"time": time.time()}
        if _HAS_PSUTIL:
            snap["cpu_percent"] = psutil.cpu_percent(interval=None)
            vm = psutil.virtual_memory()
            snap["mem_percent"] = vm.percent
            snap["mem_available_mb"] = vm.available / 1e6
        else:
            try:
                snap["loadavg"] = os.getloadavg()
            except OSError:
                pass
            kb = _proc_status_kb("VmRSS")
            if kb is not None:
                snap["rss_mb"] = kb / 1e3
        self._history.append(snap)
        return snap

    @property
    def history(self) -> list[Dict[str, Any]]:
        return list(self._history)
