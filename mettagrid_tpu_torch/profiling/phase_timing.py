"""Per-phase step timing, the StepTimingStats analogue (reference:
mettagrid_tpu/profiling/phase_timing.py).

The reference cannot time phases inside one fused XLA program, so it stubs
each phase, re-jits the step and takes the difference; its docstring names
the per-phase wall clocks of serial phases as the same measure. The port's
step runs its phases in series and opens a ``torch.profiler`` span for each
(``step.actions``, ``step.obs``, ``step.rewards``, ... in engine/step.py),
so the phases are timed in place from those spans: the same function, not
the same formulation.

``per_step`` and ``idle_by_span`` read profiling/trace.py: the untraced
totals per counted step, and the device's idle gaps of a traced window put
down to the innermost program span (a ``sync.<site>`` read, a ``step.*``
phase, the rest of the ``step`` call) the host was in, the trace's log and
the profiler's device events taken on one clock.
"""

from __future__ import annotations

import bisect
import time
from typing import Dict

import torch

PHASES = ("actions", "obs", "rewards")


def span_times(prof, n: int) -> tuple[dict, dict]:
    """The ``step.*`` spans of a torch.profiler run over n steps. Returns
    ({span: {"host_ms", "device_ms"}} per step, where device_ms is the
    device time of the kernels that start inside the span's device window,
    and {kernel name: [device ms per step, launches]})."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    spans: dict = {}
    windows = []  # (start_us, end_us, name) of each step.* span on the device timeline
    kernels = []  # (start_us, duration_us, name) of each device event
    for evt in prof.events():
        tr = evt.time_range
        if evt.name.startswith("step."):
            span = spans.setdefault(evt.name, {"host_ms": 0.0, "device_ms": 0.0})
            if evt.device_type == cpu:
                span["host_ms"] += tr.elapsed_us() / 1e3 / n
            elif evt.device_type == cuda:
                windows.append((tr.start, tr.end, evt.name))
        elif evt.device_type == cuda:
            kernels.append((tr.start, tr.elapsed_us(), evt.name))
    windows.sort()
    starts = [w[0] for w in windows]
    by_name: dict = {}
    for start, dur, name in kernels:
        i = bisect.bisect_right(starts, start) - 1
        if i >= 0 and start < windows[i][1]:
            spans[windows[i][2]]["device_ms"] += dur / 1e3 / n
        k = by_name.setdefault(name, [0.0, 0])
        k[0] += dur / 1e3 / n
        k[1] += 1
    return spans, by_name


def per_step(totals: dict) -> dict:
    """The totals of profiling/trace.py (``trace.snapshot()``) per counted
    step: {"steps", "setup_s": {setup span: seconds}, and where steps ran
    "spans": {span: {"host_ms", "self_ms", "calls"}} (self: less its child
    spans), "counts": {counter: per step}, "sync_wait_ms" (host ms in the
    ``sync.*`` reads) and "issue_ms" (the ``step`` call's host ms less those
    waits)}."""
    steps = totals.get("step.calls", {}).get("count", 0)
    out = {"steps": steps, "setup_s": {k: v["ns"] / 1e9 for k, v in totals.items() if k.startswith("setup.")}}
    if not steps:
        return out
    timed = {k: v for k, v in totals.items() if v["ns"] and not k.startswith("setup.")}
    out["spans"] = {k: {"host_ms": v["ns"] / 1e6 / steps, "self_ms": (v["ns"] - v["child_ns"]) / 1e6 / steps,
                        "calls": v["count"] / steps} for k, v in timed.items()}
    out["counts"] = {k: v["count"] / steps for k, v in totals.items() if k not in timed and k != "step.calls"
                     and not k.startswith("setup.")}
    out["sync_wait_ms"] = sum(v["ns"] for k, v in timed.items() if k.startswith("sync.")) / 1e6 / steps
    out["issue_ms"] = out["spans"].get("step", {}).get("host_ms", 0.0) - out["sync_wait_ms"]
    return out


def innermost_segments(log: list) -> list:
    """The log of profiling/trace.py ([(name, parent, start_ns, end_ns)],
    spans nested or apart) as sorted, non-overlapping (start_ns, end_ns,
    name) segments, each named by the innermost span open in it."""
    segments = []
    stack = []  # (end_ns, name) of the open spans, innermost last
    cursor = None
    for name, _parent, start, end in sorted(log, key=lambda r: (r[2], -r[3])):
        while stack and stack[-1][0] <= start:
            closed, inner = stack.pop()
            segments.append((cursor, closed, inner))
            cursor = closed
        if stack:
            segments.append((cursor, start, stack[-1][1]))
        stack.append((end, name))
        cursor = start
    while stack:
        closed, inner = stack.pop()
        segments.append((cursor, closed, inner))
        cursor = closed
    return [s for s in segments if s[1] > s[0]]


def device_intervals(prof) -> list:
    """Sorted (start_ns, end_ns) of every device operation of a
    torch.profiler run, on the wall clock the profiler stamps (the ``step.*``
    ranges' own device windows left out)."""
    cuda = torch.autograd.DeviceType.CUDA
    return sorted(
        (e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
        if e.device_type() == cuda and not e.name().startswith("step.")
    )


def idle_by_span(device: list, log: list) -> tuple[float, dict]:
    """Seconds in which some device operation ran (the union of ``device``,
    sorted (start_ns, end_ns)), and the idle seconds between them split by
    the innermost program span of the log the host was in
    (innermost_segments; "outside program spans" where none was open)."""
    segments = innermost_segments(log)
    starts = [s[0] for s in segments]
    busy = 0
    gaps: dict = {}

    def gap(a: int, b: int) -> None:
        covered = 0
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(segments) and segments[i][0] < b:
            lo, hi = max(a, segments[i][0]), min(b, segments[i][1])
            if hi > lo:
                gaps[segments[i][2]] = gaps.get(segments[i][2], 0.0) + (hi - lo) / 1e9
                covered += hi - lo
            i += 1
        if b - a > covered:
            gaps["outside program spans"] = gaps.get("outside program spans", 0.0) + (b - a - covered) / 1e9

    cur = None
    for start, end in device:
        if cur is None:
            cur = [start, end]
        elif start > cur[1]:
            busy += cur[1] - cur[0]
            gap(cur[1], start)
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy / 1e9, gaps


def measure_step_phases(
    program,
    init,
    state,
    actions,
    vibe_actions=None,
    k: int = 8,
    phases=PHASES,
) -> Dict[str, float]:
    """Per-phase seconds of the step on the device of ``state``.

    Returns {"step": total, "<phase>": cost, ..., "other": remainder}. The
    step is make_step(program, init, auto_reset=True) on that device, run k
    times from ``state`` with the same actions under torch.profiler after
    one warm-up step, its observation buffer carried. Every key reads one
    clock: on a CUDA device, "step" is the device time of all the step's
    kernels and copies and a phase the device time of the kernels its span
    launched (the profiler leaves these as they are, where it inflates the
    host clock); on the CPU, "step" is the host clock per step and a phase
    its span's host time. "other" is the step less the phases. The host
    clock per step on the card is what run_performance measures.
    """
    from mettagrid_tpu_torch.engine.step import make_step

    device = state.step_count.device
    cuda = device.type == "cuda"
    if vibe_actions is None:
        vibe_actions = torch.zeros_like(actions)
    step = make_step(program, init, auto_reset=True, device=device)
    st, out = step(state, actions, vibe_actions)
    if cuda:
        torch.cuda.synchronize(device)

    activities = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(k):
            st, out = step(st, actions, vibe_actions, None, out.observations)
        if cuda:
            torch.cuda.synchronize(device)
        host = (time.perf_counter() - t0) / k
    spans, kernels = span_times(prof, k)
    result: Dict[str, float] = {"step": sum(ms for ms, _ in kernels.values()) / 1e3 if cuda else host}
    for phase in phases:
        span = spans.get(f"step.{phase}", {"host_ms": 0.0, "device_ms": 0.0})
        result[phase] = (span["device_ms"] if cuda else span["host_ms"]) / 1e3
    result["other"] = max(result["step"] - sum(result[p] for p in phases), 0.0)
    return result
