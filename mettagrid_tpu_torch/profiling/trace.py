"""Counts and host times inside the step and its set-up, on the profiler's clock.

One recorder for the engine (it imports torch only, so engine/ imports it
without a cycle):

- ``span(name)``: a context manager. A ``step.*`` name also opens the
  ``torch.profiler.record_function`` range of that name, the phase spans that
  tools/profile_step.py and the benchmark read from the profiler's trace. The
  span adds its host duration to the totals of its name and its parent's
  child time.
- ``count(name, n=1)``: adds n to a counter, e.g. ``actions.waves``.
- ``host_read(x, site)``: the one way a step reads a device value on the host.
  It returns ``bool(x)`` (``cast(x)`` for a count) and launches what that
  call launches, nothing more; it counts ``host_syncs`` and
  ``host_syncs.<site>`` and adds the wait to the totals as the span
  ``sync.<site>``, a child of the enclosing span. It opens no profiler range.
- ``program_step(fn)``, ``first_call(fn, name)``, ``setup_span(name)``: the
  wrappers engine/step.py puts around make_reset, make_step and the
  functions they return.
- ``capturing()``: a context manager inside which ``host_read`` raises
  ``CaptureBreak`` before touching the device (a CUDA graph cannot hold a
  host read; engine/step_graphs.py captures the step inside it).

**Totals** are aggregated per name (a count, host ns, and host ns in child
spans), so memory does not grow. The per-step totals are kept only inside a
counted step call and only while no profiler session is active
(``torch.autograd._profiler_enabled()``), so they describe untraced steps:
each step function's first call is set-up (``setup.first_step``), every later
one counts as ``step.calls``, the divisor of every per-step figure, and its
host time goes to the span ``step``. The ``setup.*`` spans (``make_reset``,
``make_step``, the first ``reset``, the first step) are kept always, once per
build. ``snapshot()`` returns the totals, ``counted(name)`` one count, and
``reset()`` returns and clears them.

**The log** is kept only while a profiler session is active: each span and
host read as (name, parent, start_ns, end_ns), stamped with ``time.time_ns()``,
the wall clock on which the profiler stamps its events, so the log and the
profiler's device events share one timeline. ``drain()`` returns and clears it.

The recorder keeps one process-wide state and assumes that one thread steps.
"""

from __future__ import annotations

import contextlib
import functools
import time

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

PHASE_PREFIX = "step."
SETUP_PREFIX = "setup."
STEP = "step"
CALLS = "step.calls"
SYNCS = "host_syncs"

_now = time.time_ns
_totals: dict = {}  # name -> [count, ns, child_ns]
_log: list = []  # (name, parent, start_ns, end_ns)
_stack: list = []  # the open spans, innermost last
_sites: dict = {}  # site -> (span name, counter name)
_in_step = 0  # depth of counted step calls
_capturing = False  # inside capturing(): host reads raise


class CaptureBreak(RuntimeError):
    """A host read inside ``capturing()``."""


@contextlib.contextmanager
def capturing():
    """Host reads raise ``CaptureBreak`` inside (see the module doc)."""
    global _capturing
    saved, _capturing = _capturing, True
    try:
        yield
    finally:
        _capturing = saved


def _add(name: str, n: int, ns: int = 0, child_ns: int = 0) -> None:
    t = _totals.get(name)
    if t is None:
        _totals[name] = [n, ns, child_ns]
    else:
        t[0] += n
        t[1] += ns
        t[2] += child_ns


def _parent() -> str | None:
    return _stack[-1].name if _stack else None


class _Span:
    __slots__ = ("name", "rf", "kept", "logged", "start", "child")

    def __init__(self, name: str):
        self.name = name
        self.rf = record_function(name) if name.startswith(PHASE_PREFIX) else None

    def __enter__(self):
        if self.rf is not None:
            self.rf.__enter__()
        self.logged = _profiler_enabled()
        self.kept = self.name.startswith(SETUP_PREFIX) or (_in_step > 0 and not self.logged)
        self.child = 0
        _stack.append(self)
        self.start = _now()
        return self

    def __exit__(self, *exc):
        end = _now()
        _stack.pop()
        ns = end - self.start
        if self.kept:
            _add(self.name, 1, ns, self.child)
            if _stack:
                _stack[-1].child += ns
        if self.logged:
            _log.append((self.name, _parent(), self.start, end))
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str) -> _Span:
    """A context manager timing ``name`` on the host (see the module doc)."""
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Adds n to the counter ``name`` inside an untraced step call."""
    if _in_step and not _profiler_enabled():
        _add(name, n)


def _site(site: str) -> tuple:
    names = _sites.get(site)
    if names is None:
        names = _sites[site] = (f"sync.{site}", f"{SYNCS}.{site}")
    return names


def _synced(names: tuple, start: int, end: int, kept: bool) -> None:
    if kept:
        ns = end - start
        _add(names[0], 1, ns)
        _add(SYNCS, 1)
        _add(names[1], 1)
        if _stack:
            _stack[-1].child += ns
    else:
        _log.append((names[0], _parent(), start, end))


def host_read(x, site: str, cast=bool):
    """``cast(x)`` (bool by default; int for a count) of the device value x,
    counted and timed as the host read ``site``."""
    if _capturing:
        raise CaptureBreak(site)
    logged = _profiler_enabled()
    kept = _in_step and not logged
    if not (kept or logged):
        return cast(x)
    names = _site(site)
    start = _now()
    value = cast(x)
    _synced(names, start, _now(), kept)
    return value


def program_step(fn):
    """``fn`` (a built step) whose first call is the span
    ``setup.first_step`` and every later call a counted step: ``step.calls``
    and the span ``step``, inside which the per-step totals are kept."""
    first = True

    @functools.wraps(fn)
    def step(*args, **kwargs):
        nonlocal first
        global _in_step
        if first:
            first = False
            with span("setup.first_step"):
                return fn(*args, **kwargs)
        _in_step += 1
        try:
            if not _profiler_enabled():
                _add(CALLS, 1)
            with span(STEP):
                return fn(*args, **kwargs)
        finally:
            _in_step -= 1

    return step


def first_call(fn, name: str):
    """``fn`` whose first call is the set-up span ``name``."""
    first = True

    @functools.wraps(fn)
    def call(*args, **kwargs):
        nonlocal first
        if first:
            first = False
            with span(name):
                return fn(*args, **kwargs)
        return fn(*args, **kwargs)

    return call


def setup_span(name: str):
    """Decorator: every call of the function is the set-up span ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def counted(name: str) -> int:
    """The count of ``name`` in the totals (0 where it has none)."""
    t = _totals.get(name)
    return t[0] if t is not None else 0


def snapshot() -> dict:
    """The totals: {name: {"count", "ns", "child_ns"}}."""
    return {k: {"count": c, "ns": ns, "child_ns": ch} for k, (c, ns, ch) in _totals.items()}


def reset() -> dict:
    """The totals, then cleared."""
    out = snapshot()
    _totals.clear()
    return out


def drain() -> list:
    """The log, then cleared: [(name, parent, start_ns, end_ns)]."""
    out = list(_log)
    _log.clear()
    return out
