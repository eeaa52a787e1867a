"""Hierarchical multi-timer (reference: mettagrid_tpu/profiling/stopwatch.py).

Named timers with laps/checkpoints, context-manager and decorator forms."""

from __future__ import annotations

import functools
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class _Timer:
    elapsed: float = 0.0
    start_time: Optional[float] = None
    count: int = 0
    checkpoints: Dict[str, float] = field(default_factory=dict)
    lap_start: float = 0.0

    @property
    def running(self) -> bool:
        return self.start_time is not None


class Stopwatch:
    """Multiple named timers under one clock."""

    GLOBAL = "global"

    def __init__(self):
        self._timers: Dict[str, _Timer] = {}

    def _timer(self, name: str) -> _Timer:
        return self._timers.setdefault(name, _Timer())

    def start(self, name: str = GLOBAL) -> None:
        t = self._timer(name)
        if t.running:
            return
        t.start_time = time.perf_counter()
        t.lap_start = t.start_time

    def stop(self, name: str = GLOBAL) -> float:
        t = self._timer(name)
        if not t.running:
            return t.elapsed
        t.elapsed += time.perf_counter() - t.start_time
        t.start_time = None
        t.count += 1
        return t.elapsed

    def reset(self, name: str = GLOBAL) -> None:
        self._timers.pop(name, None)

    def elapsed(self, name: str = GLOBAL) -> float:
        t = self._timer(name)
        if t.running:
            return t.elapsed + (time.perf_counter() - t.start_time)
        return t.elapsed

    def checkpoint(self, label: str, name: str = GLOBAL) -> float:
        """Record a named checkpoint; returns the lap time since the last one."""
        t = self._timer(name)
        now = time.perf_counter()
        lap = now - t.lap_start
        t.checkpoints[label] = lap
        t.lap_start = now
        return lap

    def lap(self, name: str = GLOBAL) -> float:
        t = self._timer(name)
        now = time.perf_counter()
        lap = now - t.lap_start
        t.lap_start = now
        return lap

    @contextmanager
    def time(self, name: str):
        self.start(name)
        try:
            yield self
        finally:
            self.stop(name)

    def __call__(self, name: str):
        """Decorator form: @sw("phase")."""

        def deco(fn):
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                with self.time(name):
                    return fn(*args, **kwargs)

            return wrapper

        return deco

    def summary(self) -> Dict[str, Any]:
        return {
            name: {"elapsed": self.elapsed(name), "count": t.count, "checkpoints": dict(t.checkpoints)}
            for name, t in self._timers.items()
        }
