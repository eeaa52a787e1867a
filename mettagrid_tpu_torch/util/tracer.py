"""Chrome Trace Format span writer (reference: mettagrid_tpu/util/tracer.py).

Load the output JSON in chrome://tracing or Perfetto."""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any


class Tracer:
    def __init__(self):
        self._events: list[dict[str, Any]] = []
        self._t0 = time.perf_counter()

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    @contextmanager
    def span(self, name: str, **args: Any):
        start = self._now_us()
        try:
            yield
        finally:
            self._events.append(
                {
                    "name": name,
                    "ph": "X",
                    "ts": start,
                    "dur": self._now_us() - start,
                    "pid": os.getpid(),
                    "tid": threading.get_ident() % 1_000_000,
                    "args": args,
                }
            )

    def instant(self, name: str, **args: Any) -> None:
        self._events.append(
            {
                "name": name,
                "ph": "i",
                "ts": self._now_us(),
                "pid": os.getpid(),
                "tid": threading.get_ident() % 1_000_000,
                "s": "t",
                "args": args,
            }
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"traceEvents": self._events}, f)


class NullTracer(Tracer):
    """No-op tracer for hot paths when tracing is disabled."""

    @contextmanager
    def span(self, name: str, **args: Any):
        yield

    def instant(self, name: str, **args: Any) -> None:
        pass

    def save(self, path: str) -> None:
        pass
