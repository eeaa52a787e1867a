"""The program's own counts and host times, and the arithmetic of the
per-layer metrics that read them.

``totals()`` is the process's totals from mettagrid_tpu_torch's
profiling/trace.py (``trace.snapshot()``: {name: {"count", "ns",
"child_ns"}}), {} where the program has no such recorder. A run builds one
program, so they are its set-up spans, and the counts and host ns of its
untraced steps after the first (the traffic's warm-up steps and the window;
the traced steps are not counted). ``step.calls`` counts those steps, the
divisor of every per-step figure. Each function returns None where the
totals hold nothing to read.
"""

from __future__ import annotations

import importlib


def totals() -> dict:
    try:
        trace = importlib.import_module("mettagrid_tpu_torch.profiling.trace")
    except ImportError:
        return {}
    return trace.snapshot()


def steps(t: dict) -> int:
    return t.get("step.calls", {}).get("count", 0)


def count_per_step(t: dict, name: str):
    """The counter ``name`` per step (0 where a step ran and never counted it)."""
    n = steps(t)
    return t.get(name, {}).get("count", 0) / n if n else None


def _sync_ns(t: dict) -> int:
    return sum(v["ns"] for k, v in t.items() if k.startswith("sync."))


def sync_wait_ms(t: dict):
    """Host ms per step waiting in the ``sync.*`` reads."""
    n = steps(t)
    return _sync_ns(t) / 1e6 / n if n else None


def step_host_ms(t: dict):
    """Host ms per step in the step call (the span ``step``) less its
    ``sync.*`` waits: the host's own work of issuing the step."""
    n = steps(t)
    if not n or "step" not in t:
        return None
    return (t["step"]["ns"] - _sync_ns(t)) / 1e6 / n


def self_ms(t: dict, span: str):
    """Host ms per step in ``span`` less its child spans (its ``sync.*``
    reads among them)."""
    n = steps(t)
    if not n or span not in t:
        return None
    return (t[span]["ns"] - t[span]["child_ns"]) / 1e6 / n


def seconds(t: dict, names) -> float | None:
    """Seconds of the set-up spans ``names`` together (None where none ran)."""
    ns = [t[k]["ns"] for k in names if k in t]
    return sum(ns) / 1e9 if ns else None
